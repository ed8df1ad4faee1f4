"""The port's FLOP counts (detection_3d_tpu_torch/utils/flops.py) against
the JAX package's (utils/flops.py), on the CPU: one building's rulebook
statistics from the port's pyramid equal JAX's pair for pair, and the
per-stage GEMM FLOPs equal for the tiny, residual, grouped and
full-scale configs (the same arithmetic on the same counts)."""

import dataclasses

import pytest

from detection_3d_tpu.utils import flops as jflops
from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.utils import flops as tflops
from test_torch_common import cfg_pair, scene_tables


@pytest.fixture(scope="module")
def stats():
    jcfg, tcfg = cfg_pair()
    jt, tt = scene_tables(jcfg, tcfg)
    return (jflops.pyramid_pair_stats(jcfg, jt),
            tflops.pyramid_pair_stats(tcfg, tt))


def test_pair_stats_equal_jax(stats):
    want, got = stats
    assert got == want
    assert all(isinstance(v, int) for vals in got.values() for v in vals)
    assert got["subm_pairs"][0] > got["rows"][0] > 0


def _configs():
    jc, tc = cfg_pair()
    yield "tiny", jc, tc
    res = dataclasses.replace(jc.sparse3d, residual_block=False,
                              block_reps=2)
    yield ("vgg_blocks", jc.replace(sparse3d=res),
           tc.replace(sparse3d=dataclasses.replace(
               tc.sparse3d, residual_block=False, block_reps=2)))
    groups = (("wall",), ("door", "window"))
    yield "grouped", jc.replace(separate_classes=groups), \
        tc.replace(separate_classes=groups)


@pytest.mark.parametrize("is_train", [False, True])
def test_gemm_flops_equal_jax(stats, is_train):
    want_stats, _ = stats
    for name, jc, tc in _configs():
        got = tflops.model_gemm_flops(tc, want_stats, is_train)
        assert got == jflops.model_gemm_flops(jc, want_stats, is_train), name
        assert got["total"] == sum(v for k, v in got.items()
                                   if k != "total")


def test_gemm_flops_full_scale():
    """full_scale_config's inventory (bench.py's config in JAX) on
    made-up counts of its 9 scales and BEV slots."""
    import bench
    jc, tc = bench.full_scale_config(), tdefaults.full_scale_config()
    n = tc.sparse3d.num_scales
    slots = len(tc.rpn.rpn_scales_from_top)
    counts = {"rows": [480_000 >> s for s in range(n)],
              "subm_pairs": [6_000_000 >> s for s in range(n)],
              "down_pairs": [470_000 >> s for s in range(n - 1)],
              "up_pairs": [470_000 >> s for s in range(n - 1)],
              "bev_rows": [9_000 >> s for s in range(slots)],
              "bev_pairs": [30_000 >> s for s in range(slots)]}
    assert tflops.model_gemm_flops(tc, counts, True) == \
        jflops.model_gemm_flops(jc, counts, True)
