"""Package-level properties of the PyTorch port, on the CPU.

- Every port module and ``chip_smoke.py`` import with JAX, the JAX
  package, ``cv2`` and ``PIL`` made unimportable (a subprocess with
  ``sys.modules["jax"] = sys.modules["deepinteraction_tpu"] = None``, and
  the same for ``cv2`` and ``PIL``): the port imports neither framework nor
  package, and the card's path (JPEG decode and encode with nvJPEG) needs no
  host image library.
- The numpy copy of ``make_synthetic_batch`` is byte-identical to the JAX
  package's, and ``init_weights`` gives ``fast_init_variables``' weights.
- The weight bridge is strict: a missing leaf, an extra leaf or a wrong
  shape raises.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepinteraction_tpu_torch
from deepinteraction_tpu.configs import fusion_base_config, tiny_config
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_make_batch
from deepinteraction_tpu_torch.convert import flax_leaf_shapes, params_from_flax
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.models.sparse_encoder import SparseEncoder
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = deepinteraction_tpu_torch
    return sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    )


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "deepinteraction_tpu_torch.ops.subm_conv" in mods
    for new in ("ops.nms", "ops.jpeg", "ops.images", "eval.tta", "eval.nuscenes_metrics", "eval.results",
                "data.pipeline", "data.loader", "data.dataset", "data.nuscenes_converter", "data.splits",
                "utils.synthetic_nuscenes", "utils.torch_convert", "tools.test", "tools.convert_torch_ckpt",
                "data.gt_database", "data.anno_2d", "tools.train", "tools.benchmark", "tools.create_data",
                "parallel.mesh", "parallel.input", "utils.fuse_bn", "tools.ensemble", "tools.misc_tools",
                "tools.analyze_logs", "data.native", "data.extra_transforms", "ops.flops", "tools.get_flops",
                "tools.trace_model", "tools.analyze_trace", "levers", "tools.gate_eval"):
        assert f"deepinteraction_tpu_torch.{new}" in mods, new
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'deepinteraction_tpu', 'cv2', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('deepinteraction_tpu.', 'jax.', 'flax.', 'cv2.', 'PIL.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("cfg_fn,b,seed,with_gt", [
    (tiny_config, 1, 7, True), (tiny_config, 2, 3, False), (fusion_base_config, 1, 0, False),
])
def test_synthetic_batch_byte_identical(cfg_fn, b, seed, with_gt):
    cfg = cfg_fn()
    want = jax_make_batch(cfg, b=b, seed=seed, with_gt=with_gt)
    got = make_synthetic_batch(cfg, b=b, seed=seed, with_gt=with_gt)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_init_weights_follow_fast_init_recipe():
    """init_weights draws the fast_init_variables recipe in Flax flatten
    order; checked leaf by leaf on the sparse encoder's Flax shapes."""
    import jax

    from deepinteraction_tpu.models.sparse_encoder import SparseEncoder as JaxSparseEncoder
    from deepinteraction_tpu.utils.testing import fast_init_variables

    cfg = tiny_config().model.pts_middle_encoder
    k = 64
    feats = np.zeros((1, k, cfg.in_channels), np.float32)
    coords = np.zeros((1, k, 3), np.int32)
    valid = np.zeros((1, k), bool)

    class Wrap:  # fast_init_variables calls model.init(rng, batch, False)
        def init(self, rng, batch, train):
            return JaxSparseEncoder(cfg, impl="gather").init(rng, *batch, train)

    want = jax.tree_util.tree_map(np.asarray, fast_init_variables(Wrap(), (feats, coords, valid), seed=3))
    port = SparseEncoder(cfg)
    init_weights(port, seed=3)
    ref = params_from_flax(want, SparseEncoder(cfg))
    for key, t in port.state_dict().items():
        assert torch.equal(t, ref[key]), key


def test_bridge_is_strict():
    cfg = tiny_config()
    model = SparseEncoder(cfg.model.pts_middle_encoder)
    shapes = flax_leaf_shapes(model)
    leaves = {p: np.zeros(s, np.float32) for p, s in shapes.items()}
    sd = params_from_flax(leaves, model)
    assert set(sd) == set(model.state_dict())

    missing = dict(leaves)
    missing.pop("params/conv_input/w")
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(missing, model)
    extra = dict(leaves, **{"params/stage9_block0/w1": np.zeros((27, 4, 4), np.float32)})
    with pytest.raises(KeyError, match="not consumed"):
        params_from_flax(extra, model)
    wrong = dict(leaves, **{"batch_stats/conv_input/bn/mean": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(wrong, model)


def test_full_model_leaf_count():
    """The fusion_base port maps onto one Flax leaf per tensor (no full-size
    forward: construction only)."""
    cfg = fusion_base_config()
    with torch.device("meta"):
        model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals)
    shapes = flax_leaf_shapes(model)
    assert len(shapes) == len(model.state_dict())
    assert shapes["params/pts_middle_encoder/conv_input/w"] == (27, 5, 16)
    assert shapes["params/img_backbone/conv1/kernel"] == (7, 7, 3, 64)
    assert shapes["params/imgpts_neck/layer1/i2p/q_proj/kernel"] == (128, 128)
    assert shapes["params/pts_neck/deblock1_conv/kernel"] == (2, 2, 256, 256)
