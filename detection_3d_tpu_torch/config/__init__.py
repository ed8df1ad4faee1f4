from detection_3d_tpu_torch.config.defaults import (  # noqa: F401
    CapacityConfig, Config, ROIConfig, RPNConfig, Sparse3DConfig,
    SolverConfig, TestConfig, default_config, full_scale_config,
    small_config,
)
from detection_3d_tpu_torch.config.yaml_loader import (  # noqa: F401
    load_yaml_config,
)
