from detection_3d_tpu_torch.evaluation.detection_eval import (  # noqa: F401
    DetectionEvalResult, evaluate_detections, save_results, voc_ap_07,
)
