"""The port's data path and eval CLI against the JAX package, on the CPU.

A tree written by the JAX package's ``write_synthetic_nuscenes`` (3
samples, 6 cameras of 32x24) is converted by both converters; then:

- the port converter's infos equal JAX's exactly;
- ``build_sample`` in eval and in train for several seeds: points and boxes
  exactly, the matrices within 1e-6 and the images within 1e-5 after the
  port's image stage (``ops/images.py``, cv2 decode on the CPU);
- the loader's batches (the port's through a spawned worker) and
  ``pad_count`` equal JAX's;
- the port's realistic writer (``utils/synthetic_nuscenes.py``) writes the
  JAX writer's tables and clouds byte for byte; its camera renders are made
  without cv2 (its own polygon fill and upsampling), so their pixels differ
  at polygon edges: held to a mean of 2 levels, and to 5 % of pixels more
  than 8 levels apart;
- the slice as a whole: ``python -m deepinteraction_tpu_torch.tools.test
  tiny --device cpu`` (plain and ``--tta``) with a port checkpoint bridged
  from the JAX package's initial weights, against JAX's forward +
  ``get_bboxes`` (+ ``tta_inference``) + metrics over the JAX loader, both
  packages' I2P and BEVWarp at their shipped view settings (two views a
  pillar and a point) and in their all-view form: detections rtol 2e-3 /
  atol 5e-4, labels exact, metrics within 1e-6.
"""

import filecmp
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepinteraction_tpu.configs import apply_overrides as japply
from deepinteraction_tpu.configs import tiny_config as jtiny
from deepinteraction_tpu.data import DataLoader as JLoader
from deepinteraction_tpu.data import NuScenesDataset as JDataset
from deepinteraction_tpu.data import pipeline as jpipe
from deepinteraction_tpu.data.nuscenes_converter import create_nuscenes_infos as jcreate
from deepinteraction_tpu.eval.nuscenes_metrics import evaluate_detections
from deepinteraction_tpu.eval.results import ego_origin_in_lidar, gt_frame_from_info, predictions_to_frame
from deepinteraction_tpu.eval.tta import tta_inference
from deepinteraction_tpu.inference import get_bboxes
from deepinteraction_tpu.models.detector import DeepInteraction as JModel
from deepinteraction_tpu.utils.synthetic_nuscenes import write_realistic_nuscenes as jwrite_realistic
from deepinteraction_tpu.utils.synthetic_nuscenes import write_synthetic_nuscenes
from deepinteraction_tpu.utils.testing import fast_init_variables, make_synthetic_batch
from deepinteraction_tpu_torch.configs import apply_overrides as tapply
from deepinteraction_tpu_torch.configs import tiny_config as ttiny
from deepinteraction_tpu_torch.convert import params_from_flax
from deepinteraction_tpu_torch.data import DataLoader as TLoader
from deepinteraction_tpu_torch.data import NuScenesDataset as TDataset
from deepinteraction_tpu_torch.data import collate
from deepinteraction_tpu_torch.data import pipeline as tpipe
from deepinteraction_tpu_torch.data.nuscenes_converter import create_nuscenes_infos as tcreate
from deepinteraction_tpu_torch.models.detector import DeepInteraction as TModel
from deepinteraction_tpu_torch.ops.images import to_device
from deepinteraction_tpu_torch.tools import test as cli
from deepinteraction_tpu_torch.train.checkpoint import save_checkpoint
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.synthetic_nuscenes import write_realistic_nuscenes as twrite_realistic

torch.set_num_threads(1)

SIX_VIEWS = {"data.num_views": "6"}  # the tree's rig; the model takes V from the batch


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    write_synthetic_nuscenes(root, num_samples=3)
    val = {"scene-9001"}  # every sample in val
    jpaths = jcreate(root, os.path.join(root, "jax"), version="v1.0-mini", val_scene_names=val)
    tpaths = tcreate(root, os.path.join(root, "port"), version="v1.0-mini", val_scene_names=val)
    return root, jpaths[1], tpaths[1]


def _assert_same(a, b, path="infos"):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, path


def test_converter_infos_equal_jax(tree):
    _, jpath, tpath = tree
    with open(jpath, "rb") as f:
        want = pickle.load(f)
    with open(tpath, "rb") as f:
        got = pickle.load(f)
    assert len(want["infos"]) == 3
    _assert_same(got, want)


def test_val_scenes_match_jax(tmp_path):
    from deepinteraction_tpu.data.splits import val_scenes as jval
    from deepinteraction_tpu_torch.data.splits import val_scenes as tval

    for version in ("v1.0-mini", "v1.0-test"):
        assert tval(version) == jval(version)
    with pytest.raises(FileNotFoundError):
        tval("v1.0-trainval", str(tmp_path))
    (tmp_path / "val_scenes.txt").write_text("scene-0003\nscene-0012\n\n")
    assert tval("v1.0-trainval", str(tmp_path)) == jval("v1.0-trainval", str(tmp_path)) == {"scene-0003", "scene-0012"}


def _cfgs():
    return japply(jtiny(), SIX_VIEWS), tapply(ttiny(), SIX_VIEWS)


def _compare_samples(want, got, cfg):
    """A JAX sample or batch against a port host sample or batch after its
    image stage on the CPU."""
    batched = isinstance(got["jpeg"][0], list)
    dev = to_device(got if batched else collate([got]), cfg.data, "cpu")
    for k, w in want.items():
        if k in ("token", "pad_count"):
            assert got[k] == w, k
            continue
        g = dev[k].numpy() if batched else dev[k].numpy()[0]
        tol = {"images": 1e-5, "lidar2img": 1e-6, "img2lidar": 1e-6}.get(k, 0.0)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol * max(1.0, np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("train,seed", [(False, 0), (True, 0), (True, 1), (True, 2), (True, 3)])
def test_build_sample_matches_jax(tree, train, seed):
    _, jpath, _ = tree
    jcfg, tcfg = _cfgs()
    with open(jpath, "rb") as f:
        info = pickle.load(f)["infos"][seed % 3]
    want = jpipe.build_sample(info, jcfg, train, np.random.default_rng(seed))
    got = tpipe.build_sample(info, tcfg, train, np.random.default_rng(seed))
    assert set(want) - {"images", "img2lidar"} <= set(got)
    _compare_samples(want, got, tcfg)


def test_train_flip_fires_in_the_seeds(tree):
    """Seeds 0-3 above include a horizontal flip, so the image flip and its
    fold into lidar2img are compared."""
    _, jpath, _ = tree
    _, tcfg = _cfgs()
    with open(jpath, "rb") as f:
        infos = pickle.load(f)["infos"]
    flips = [bool(tpipe.build_sample(infos[s % 3], tcfg, True, np.random.default_rng(s))["img_flip"])
             for s in range(4)]
    assert any(flips) and not all(flips), flips


@pytest.mark.parametrize("train,workers", [(False, 1), (True, 0)])
def test_loader_batches_match_jax(tree, train, workers):
    _, jpath, tpath = tree
    jcfg, tcfg = _cfgs()
    jl = JLoader(JDataset(jcfg, jpath, train=train, use_cbgs=False), 2, num_workers=0)
    tl = TLoader(TDataset(tcfg, tpath, train=train, use_cbgs=False), 2, num_workers=workers)
    try:
        want, got = list(jl.epoch(1)), list(tl.epoch(1))
    finally:
        tl.close()
    assert len(got) == len(want) == (1 if train else 2)
    if not train:
        assert [b["pad_count"] for b in got] == [b["pad_count"] for b in want] == [0, 1]
    for w, g in zip(want, got):
        _compare_samples(w, g, tcfg)


def test_loader_workers_import_no_torch():
    """What a loader worker imports (the pipeline, the dataset, the loader,
    and the module of the CLI that started it, eval, train or benchmark,
    which a spawned worker imports as the program's main module) pulls in
    numpy and no torch: spawned workers start in well under a second
    instead of importing torch each."""
    import subprocess
    import sys

    code = ("import sys\nimport deepinteraction_tpu_torch.data.loader\n"
            "import deepinteraction_tpu_torch.tools.test\nimport deepinteraction_tpu_torch.tools.train\n"
            "import deepinteraction_tpu_torch.tools.benchmark\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)[:5]\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_realistic_writer_matches_jax(tmp_path):
    import cv2

    kw = dict(num_scenes=2, samples_per_scene=2, num_objects=6, num_val_scenes=1, image_hw=(90, 160),
              az_steps=120, beams=8)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jwrite_realistic(jroot, **kw)
    twrite_realistic(troot, device="cpu", **kw)
    n_img = 0
    for dirpath, _, files in os.walk(jroot):
        for name in files:
            a = os.path.join(dirpath, name)
            b = os.path.join(troot, os.path.relpath(a, jroot))
            if name.endswith(".jpg"):
                x, y = cv2.imread(a).astype(int), cv2.imread(b).astype(int)
                assert x.shape == y.shape == (90, 160, 3)
                d = np.abs(x - y)
                assert d.mean() < 2.0 and (d.max(-1) > 8).mean() < 0.05, (name, d.mean())
                n_img += 1
            else:
                assert filecmp.cmp(a, b, shallow=False), name
    assert n_img == 2 * 2 * 6
    with open(os.path.join(troot, "v1.0-trainval", "sample_annotation.json")) as f:
        assert len(json.load(f)) == 2 * 2 * 6


def _views(views, monkeypatch):
    """Both packages' I2P and BEVWarp view settings: ``shipped``, each at
    its default (two views a pillar and a point); ``all``, every view
    (``DI_I2P_VIEWS=0`` / ``DI_WARP_VIEWS=0``, which the port's CLI reads
    and JAX's ``DI_WARP_VIEWS`` too; JAX's ``n_views`` through a
    subclass, since it reads ``DI_I2P_VIEWS`` at import)."""
    import deepinteraction_tpu.models.mmri_encoder as jmmri

    if views == "shipped":
        for name in ("DI_I2P_VIEWS", "DI_WARP_VIEWS"):
            monkeypatch.delenv(name, raising=False)
        assert jmmri.MMRI_I2P.n_views == 2
        return

    class AllViewsI2P(jmmri.MMRI_I2P):
        n_views: int = 0

    monkeypatch.setattr(jmmri, "MMRI_I2P", AllViewsI2P)
    monkeypatch.setenv("DI_I2P_VIEWS", "0")
    monkeypatch.setenv("DI_WARP_VIEWS", "0")


def _jax_reference(jcfg, jpath, variables, tta):
    """JAX's forward + get_bboxes (+ tta_inference) + metrics over the JAX
    loader, as tools/test.py runs them on one device."""
    model = JModel(jcfg.model, jcfg.data.padded_img_shape, num_proposals=jcfg.test_num_proposals)
    dcfg = jcfg.model.pts_bbox_head

    @jax.jit
    def forward(v, batch):
        return get_bboxes(model.apply(v, batch, False), dcfg, jcfg.model.bbox_coder, jcfg.test_num_proposals)

    ds = JDataset(jcfg, jpath, train=False)
    dets, frames, tokens = [], [], []
    for batch in JLoader(ds, jcfg.data.samples_per_device, num_workers=0).epoch(0, shuffle=False):
        pad = batch.pop("pad_count")
        toks = batch.pop("token")
        arrays = {k: jnp.asarray(v) for k, v in batch.items()}
        b = len(toks) - pad
        if tta:
            fused = tta_inference(forward, variables, arrays)
            dets.extend(fused[:b])
        else:
            det = jax.tree_util.tree_map(np.asarray, forward(variables, arrays))
            dets.append(det)
            frames.extend(predictions_to_frame(det.boxes[i], det.scores[i], det.labels[i], det.keep[i],
                                               jcfg.data.class_names) for i in range(b))
        tokens.extend(toks[:b])
    return dets, frames, tokens, ds.infos


def _metrics(frames, tokens, infos, class_names):
    by_token = {i["token"]: i for i in infos}
    for f, t in zip(frames, tokens):
        f.ego_translation = ego_origin_in_lidar(by_token[t])
    return evaluate_detections([gt_frame_from_info(by_token[t]) for t in tokens], frames, class_names)


@pytest.fixture(scope="module")
def jax_variables(tree, tmp_path_factory):
    """JAX's initial weights and a port checkpoint bridged from them."""
    jcfg, tcfg = _cfgs()
    model = JModel(jcfg.model, jcfg.data.padded_img_shape, num_proposals=jcfg.test_num_proposals)
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_batch(jcfg, b=1).items()}
    variables = fast_init_variables(model, batch, seed=3)
    port = TModel(tcfg.model, tcfg.data.padded_img_shape)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables), port), strict=True)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(ckpt, TrainStep(tcfg, port, total_steps=1, device="cpu"))
    return variables, ckpt


@pytest.mark.parametrize("views", ["shipped", "all"])
def test_eval_cli_matches_jax(views, tree, jax_variables, tmp_path, monkeypatch):
    _views(views, monkeypatch)
    _, jpath, tpath = tree
    jcfg, _ = _cfgs()
    variables, ckpt = jax_variables
    out = str(tmp_path / "dets.pkl")
    res = cli.main(["tiny", "--infos", tpath, "--device", "cpu", "--checkpoint", ckpt, "--num-workers", "0",
                    "--out", out, "--cfg-options", *(f"{k}={v}" for k, v in SIX_VIEWS.items())])
    dets, frames, tokens, infos = _jax_reference(jcfg, jpath, variables, tta=False)
    assert res["tokens"] == tokens and len(tokens) == 3
    assert len(res["detections"]) == len(dets) == 3
    for g, w in zip(res["detections"], dets):
        for name in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(g, name).numpy(), getattr(w, name), rtol=2e-3, atol=5e-4,
                                       err_msg=name)
        np.testing.assert_array_equal(g.labels.numpy(), w.labels)
        np.testing.assert_array_equal(g.keep.numpy(), w.keep)
    want = _metrics(frames, tokens, infos, jcfg.data.class_names)
    assert set(res["metrics"]) == set(want)
    for k in want:
        assert abs(res["metrics"][k] - want[k]) <= 1e-6, (k, res["metrics"][k], want[k])
    with open(out, "rb") as f:
        assert pickle.load(f)["tokens"] == tokens
    assert res["timing"]["frames"] == 3 and res["timing"]["fps"] > 0


@pytest.mark.parametrize("views", ["shipped", "all"])
def test_eval_cli_tta_matches_jax(views, tree, jax_variables, monkeypatch):
    _views(views, monkeypatch)
    _, jpath, tpath = tree
    jcfg, _ = _cfgs()
    variables, ckpt = jax_variables
    res = cli.main(["tiny", "--infos", tpath, "--device", "cpu", "--checkpoint", ckpt, "--num-workers", "0",
                    "--tta", "--cfg-options", *(f"{k}={v}" for k, v in SIX_VIEWS.items())])
    fused, _, tokens, infos = _jax_reference(jcfg, jpath, variables, tta=True)
    assert res["tokens"] == tokens and len(res["frames"]) == len(fused) == 3
    for frame, (boxes, scores, labels) in zip(res["frames"], fused):
        assert len(frame.scores) == len(scores) > 0
        np.testing.assert_allclose(frame.boxes, boxes[:, :7], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(frame.velocity, boxes[:, 7:9], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(frame.scores, scores, rtol=2e-3, atol=5e-4)
        np.testing.assert_array_equal(frame.names, [jcfg.data.class_names[int(j)] for j in labels])


def test_eval_cli_needs_a_card_unless_told(tree):
    _, _, tpath = tree
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["tiny", "--infos", tpath])


def _sampling(jpg: bytes):
    """(vertical, horizontal) luma sampling factors from a JPEG's SOF0."""
    i = jpg.index(b"\xff\xc0")
    return jpg[i + 11] & 15, jpg[i + 11] >> 4


def _flat_jpeg(rng, h, w, fy, fx, flag):
    """An RGB image of one random colour a luma MCU (8*fy x 8*fx pixels),
    its JPEG at quality 100 with that subsampling, and the planes the
    decoder holds before upsampling: every block is flat, so its one DC
    coefficient decodes exactly (in any IDCT) to libjpeg's forward
    conversion (``jccolor.c``) of its colour."""
    import cv2

    colors = rng.integers(0, 256, size=(-(-h // (8 * fy)), -(-w // (8 * fx)), 3))
    img = colors.repeat(8 * fy, 0).repeat(8 * fx, 1)[:h, :w].astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    assert ok
    fix = lambda x: int(x * 65536 + 0.5)
    r, g, b = (colors[..., k].astype(np.int64) for k in range(3))
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + 32768) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + (128 << 16) + 32767) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + (128 << 16) + 32767) >> 16
    hc, wc = -(-h // fy), -(-w // fx)
    planes = [torch.from_numpy(y.repeat(8 * fy, 0).repeat(8 * fx, 1)[:h, :w].astype(np.uint8))]
    planes += [torch.from_numpy(c.repeat(8, 0).repeat(8, 1)[:hc, :wc].astype(np.uint8)) for c in (cb, cr)]
    return buf, planes


@pytest.mark.parametrize("sub", ["444", "422", "440", "420"])
def test_libjpeg_upsampling_and_colour_conversion_exact(sub):
    """The card's decode upsamples nvJPEG's chroma planes and converts them
    to RGB with ``upsample_chroma`` and ``ycc_to_rgb``: on the planes of
    flat-block JPEGs they give libjpeg's pixels (``cv2.imdecode``) exactly,
    at odd sizes with partial MCUs and at planes 2 samples wide; nearest
    upsampling does not (the check sees the filter)."""
    import cv2

    from deepinteraction_tpu_torch.ops import jpeg

    flag = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sub)
    fy, fx = {"444": (1, 1), "422": (1, 2), "440": (2, 1), "420": (2, 2)}[sub]
    rng = np.random.default_rng(int(sub))
    for h, w in [(65, 97), (64, 96), (33, 4), (9, 3)]:
        buf, (y, cb, cr) = _flat_jpeg(rng, h, w, fy, fx, flag)
        assert _sampling(bytes(buf)) == (fy, fx)
        want = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]
        got = jpeg.ycc_to_rgb(y, jpeg.upsample_chroma(cb, fy, fx)[:h, :w], jpeg.upsample_chroma(cr, fy, fx)[:h, :w])
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{sub} {h}x{w}")
        if (fy, fx) != (1, 1) and (h, w) == (65, 97):
            near = [c.repeat_interleave(fy, 0).repeat_interleave(fx, 1)[:h, :w] for c in (cb, cr)]
            assert not np.array_equal(jpeg.ycc_to_rgb(y, *near).numpy(), want)


def test_jpeg_fixtures_and_codec_on_cpu():
    """The committed fixtures (``chip_smoke.py`` holds nvJPEG to them) decode
    on the CPU path to the stored libjpeg pixels exactly; the 4:4:4 fixture
    is the 97x65 fixture's pixels re-encoded without chroma subsampling and
    the flat one a flat-block 4:2:0 image (``_flat_jpeg``), each as cv2
    writes it again; the CPU encoder round-trips a frame at quality 95
    above 35 dB."""
    import cv2

    from deepinteraction_tpu_torch.ops import jpeg

    fixtures = os.path.join(os.path.dirname(jpeg.__file__), "..", "fixtures")
    want = np.load(os.path.join(fixtures, "jpeg_pixels.npz"))
    names = ["jpeg_96x64", "jpeg_97x65", "jpeg_97x65_444", "jpeg_flat_97x65"]
    assert sorted(want.files) == sorted(names)
    files = [np.fromfile(os.path.join(fixtures, n + ".jpg"), np.uint8) for n in names]
    assert [_sampling(f.tobytes()) for f in files] == [(2, 2), (2, 2), (1, 1), (2, 2)]
    got = jpeg.decode(files, "cpu")
    for n, g in zip(names, got):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), want[n])
    ok, again = cv2.imencode(".jpg", np.ascontiguousarray(want["jpeg_97x65"][:, :, ::-1]),
                             [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    np.testing.assert_array_equal(again.reshape(-1), files[2])
    flat, _ = _flat_jpeg(np.random.default_rng(0), 65, 97, 2, 2, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    np.testing.assert_array_equal(flat.reshape(-1), files[3])
    img = got[1]
    back = jpeg.decode([jpeg.encode(img, quality=95)], "cpu")[0]
    mse = (back.float() - img.float()).pow(2).mean().item()
    assert 10 * np.log10(255.0**2 / mse) > 35
    with pytest.raises(ValueError):
        jpeg.encode(img.float())
