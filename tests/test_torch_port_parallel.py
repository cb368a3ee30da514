"""The port's data parallelism (``parallel/``) against the JAX package and
against one process, on the CPU with gloo.

- ``process_shard_indices`` and the loader's per-rank batches, train and
  eval, for 2 and 3 ranks on a stub dataset of 11: exactly JAX's
  ``process_shard_indices`` and ``DataLoader(process_index=...,
  process_count=...)``.
- One two-rank gloo job (``tests/torch_parallel_job.py``, spawned once for
  the module on a free port) whose report the tests below read:

  - ``gather_results``: rank 0 gets both ranks' items in rank order, rank 1
    ``None``;
  - one ``tiny_lidar_config`` and one ``tiny_config`` (fusion) step at B=1
    a rank against the port's one-process B=2 step, all in float64: the
    loss terms, ``matched_ious`` and ``grad_norm`` at rtol 1e-8, and every
    gradient leaf, every updated parameter and the BN running statistics at
    1e-8 of their scale (they agree to about 1e-13; leaves that are 0 in
    exact arithmetic hold noise on both sides, as in
    ``tests/test_torch_port_train.py``). Both configs have dropout 0 (the v1 decoder is the
    only dropout and both configs set it to 0; the MMRI encoder has none),
    so no mask needs replaying. The lidar step is also held to JAX
    ``make_train_step`` at B=2 on the same weights, at the tolerances of
    ``tests/test_torch_port_train.py``. So two ranks take the global
    batch's step: global BN statistics, normalisers and gradient sums,
    not per-rank ones;
  - after the steps the two ranks' parameters are bit-equal, and their
    dropout generators (the train CLI's ``rank_seed``) draw different
    masks, rank 0's the one-process mask;
  - a ``tiny_config`` eval forward under the group issues no collective;
  - the eval CLI at two ranks on the tiny tree that ``tools.create_data``
    writes (its 3 samples): rank 0's metrics equal the one-process CLI's, its ``--out``
    tokens are the rank shards concatenated in rank order (JAX's order),
    and its boxes are bit-equal to the one-process run's.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepinteraction_tpu import configs as jcfg
from deepinteraction_tpu.data.loader import DataLoader as JaxDataLoader
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.parallel.input import process_shard_indices as jax_shard
from deepinteraction_tpu.train.step import create_train_state, make_train_step
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch import configs as tcfg
from deepinteraction_tpu_torch.convert import flax_from_params, grads_from_flax, params_from_flax
from deepinteraction_tpu_torch.data import DataLoader
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops.dropout import apply_dropout
from deepinteraction_tpu_torch.parallel.input import gather_results, process_shard_indices
from deepinteraction_tpu_torch.tools import create_data
from deepinteraction_tpu_torch.tools import test as test_cli
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch

import torch_parallel_job as job

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_TOL = 1e-8  # two ranks against one process, float64
# JAX's fp32 step, as tests/test_torch_port_train.py holds it
LOSS_RTOL, GRAD_TOL, STATS_TOL = 1e-3, 1e-3, 1e-5


class StubDataset:
    """11 samples whose content is their index; shuffled by epoch as the
    datasets shuffle."""

    def __init__(self, train: bool):
        self.train, self.epoch = train, 0

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"idx": np.asarray([i]), "token": f"t{i}"}

    def epoch_indices(self, epoch, shuffle=True):
        idx = np.arange(11)
        if shuffle:
            np.random.default_rng((0, epoch)).shuffle(idx)
        return idx


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("local_batch", [1, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_process_shard_indices_equal_jax(count, local_batch, drop_last):
    ids = list(np.random.default_rng(5).permutation(11))
    shards = [process_shard_indices(ids, local_batch, r, count, drop_last) for r in range(count)]
    assert shards == [jax_shard(ids, local_batch, r, count, drop_last) for r in range(count)]
    if drop_last:
        assert len({len(s) for s in shards}) == 1


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("train", [True, False])
def test_loader_rank_batches_equal_jax(count, train):
    def batches(loader_cls, r):
        loader = loader_cls(StubDataset(train), 2, num_workers=0, process_index=r, process_count=count)
        return [(b["idx"][:, 0].tolist(), b["token"], b.get("pad_count")) for b in loader.epoch(1)]

    per_rank = [batches(DataLoader, r) for r in range(count)]
    assert per_rank == [batches(JaxDataLoader, r) for r in range(count)]
    if train:
        assert len({len(b) for b in per_rank}) == 1  # every rank runs the same number of steps
    else:
        seen = sorted(i for b in per_rank for ids, _, pad in b for i in ids[: len(ids) - pad])
        assert seen == list(range(11))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _unflatten(flat):
    tree = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _jax_lidar_step():
    """JAX ``make_train_step`` at B=2 on the port's ``init_weights(seed=3)``
    (``fast_init_variables``' weights): metrics, the gradients read back from
    Adam's first moment (``(1 - b1) * clip(g)`` after one step) and the new
    state."""
    cfg = jcfg.tiny_lidar_config()
    pcfg = tcfg.tiny_lidar_config()
    port = DeepInteraction(pcfg.model, pcfg.data.padded_img_shape)
    init_weights(port, seed=job.SEED)
    state = create_train_state(cfg, _unflatten(flax_from_params(port)), job.TOTAL_STEPS)
    batch = {k: jnp.asarray(v) for k, v in jax_batch(cfg, b=2, with_gt=True, seed=job.SEED).items()}
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    new_state, metrics = jax.jit(make_train_step(cfg, model, job.TOTAL_STEPS))(state, batch, jax.random.PRNGKey(0))
    new_state, metrics = jax.tree_util.tree_map(np.asarray, (new_state, metrics))
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    norm, max_norm = float(metrics["grad_norm"]), cfg.optim.grad_clip_norm
    unclip = norm / max_norm if norm >= max_norm else 1.0
    grads = jax.tree_util.tree_map(lambda m: m / np.float32(1.0 - cfg.optim.momentum_base) * unclip, adam[0].mu)
    stats = params_from_flax({"params": new_state.params, "batch_stats": new_state.batch_stats}, port)
    return {"metrics": metrics, "grads": grads_from_flax(grads, port), "stats": stats}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two-rank job, and beside it the one-process references: the B=2
    steps, JAX's lidar step and the one-process eval CLI."""
    root = str(tmp_path_factory.mktemp("nusc"))
    out = str(tmp_path_factory.mktemp("ranks"))
    written = create_data.main(["synthetic", "--root", root, "--device", "cpu", "--num-samples", "3"])
    val_pkl = written[0]  # the tiny tree's one scene is in its train split; evaluated as it is
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_parallel_job.py"), out, val_pkl],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        ref = {"lidar": job.train_step(tcfg.tiny_lidar_config()), "fusion": job.train_step(tcfg.tiny_config())}
        ref["jax_lidar"] = _jax_lidar_step()
        one = os.path.join(out, "one.pkl")
        ref["eval_cli"] = test_cli.main(["tiny", "--infos", val_pkl, "--device", "cpu", "--num-workers", "0",
                                         "--out", one, *job.EVAL_OPTIONS])
        ref["eval_out"] = one
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return ranks, ref


def test_gather_results_rank_order(run):
    ranks, _ = run
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["gather"] == ["p0_0", "p0_1", "p1_0", "p1_1", "p1_2"]
    assert ranks[1]["gather"] is None
    items = ["a", "b"]
    assert gather_results(items) is items  # one process: unchanged


def _far_leaves(got: dict, want: dict, tol: float) -> list:
    """The leaves of ``got`` farther than ``tol`` of their scale from
    ``want``'s. A leaf that is 0 in exact arithmetic (a bias whose shift a
    softmax or a train-mode BN downstream cancels; its update after one
    step) holds rounding noise, about 1e-19 of the tree's largest value in
    float64, on both sides: such a leaf (below 1e-12 of that value) must be
    noise on both sides."""
    noise = 1e-12 * max(t.abs().max().item() for t in want.values())
    bad = []
    for k, t in want.items():
        scale = t.abs().max().item()
        if scale < noise:
            ok = got[k].abs().max().item() < noise
        else:
            ok = (got[k] - t).abs().max().item() <= tol * scale
        if not ok:
            bad.append(k)
    return bad


@pytest.mark.parametrize("name", ["lidar", "fusion"])
def test_two_ranks_take_the_global_batch_step(run, name):
    ranks, ref = run
    want = ref[name]
    assert tcfg.tiny_lidar_config().model.pts_bbox_head.dropout == tcfg.tiny_config().model.pts_bbox_head.dropout == 0
    for r, rep in enumerate(ranks):
        got = rep[name]
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=DP_TOL, err_msg=f"rank {r} {k}")
        assert got["collectives"] > 0
        assert got["grads"].keys() == want["grads"].keys()
        assert not _far_leaves(got["grads"], want["grads"], DP_TOL), r
        floats = {k: t for k, t in want["state"].items() if t.is_floating_point()}
        assert not _far_leaves(got["state"], floats, DP_TOL), r
    assign = torch.cat([rep[name]["assign"] for rep in ranks])
    assert torch.equal(assign, want["assign"]) and (assign >= 0).any()
    # the BN statistics moved, so the comparison above covers them
    stats = [k for k in want["state"] if k.endswith("running_var")]
    assert len(stats) > 10 and not all(torch.equal(want["state"][k], torch.ones_like(want["state"][k]))
                                       for k in stats)


def test_two_rank_lidar_step_equals_jax(run):
    ranks, ref = run
    got, want = ranks[0]["lidar"], ref["jax_lidar"]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=LOSS_RTOL, err_msg=k)
    grads = want["grads"]
    # leaves with gradient 0 in exact arithmetic hold rounding noise on both
    # sides (tests/test_torch_port_train.py says which)
    noise = 1e-8 * max(g.abs().max().item() for g in grads.values())
    bad = []
    for k, g in grads.items():
        mine = got["grads"].get(k, torch.zeros_like(g)).float()
        scale = g.abs().max().item()
        ok = mine.abs().max().item() < noise if scale < noise else (mine - g).abs().max().item() <= GRAD_TOL * scale
        if not ok:
            bad.append(k)
    assert not bad, bad[:10]
    for k, t in want["stats"].items():
        if "running" in k:
            np.testing.assert_allclose(got["state"][k].numpy(), t.numpy(), rtol=STATS_TOL, atol=STATS_TOL, err_msg=k)


def test_ranks_stay_equal_and_draw_their_own_dropout(run):
    ranks, _ = run
    for name in ("lidar", "fusion"):
        a, b = ranks[0][name]["state"], ranks[1][name]["state"]
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert not torch.equal(ranks[0]["dropout_mask"], ranks[1]["dropout_mask"])
    one = apply_dropout(torch.ones(256), 0.5, True, torch.Generator().manual_seed(0)) > 0
    assert torch.equal(ranks[0]["dropout_mask"], one)


def test_eval_forward_issues_no_collective(run):
    ranks, _ = run
    assert [r["eval_collectives"] for r in ranks] == [0, 0]
    cfg = tcfg.tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals).eval()
    init_weights(model, seed=job.SEED)
    want = model(to_torch(make_synthetic_batch(cfg, b=1, seed=job.SEED), "cpu"))["heatmap"]
    for r in ranks:
        assert torch.equal(r["eval_heatmap"], want)


def test_two_rank_eval_cli_equals_one_process(run):
    ranks, ref = run
    assert ranks[1]["eval_cli"] is None
    got = ranks[0]["eval_cli"]
    assert got["metrics"] == ref["eval_cli"]["metrics"]
    with open(got["out"], "rb") as f:
        two = pickle.load(f)
    with open(ref["eval_out"], "rb") as f:
        one = pickle.load(f)
    assert len(one["tokens"]) == 3
    assert two["tokens"] == one["tokens"][0::2] + one["tokens"][1::2]
    by_token = dict(zip(one["tokens"], one["frames"]))
    for t, f in zip(two["tokens"], two["frames"]):
        g = by_token[t]
        assert np.array_equal(f.boxes, g.boxes) and np.array_equal(f.scores, g.scores)
        assert np.array_equal(f.names, g.names) and np.array_equal(f.velocity, g.velocity)
