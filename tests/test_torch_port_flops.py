"""The FLOP counter (``tools/get_flops.py``, ``ops/flops.py``), on the CPU.

- params: the port's ``get_flops`` count equals the JAX tool's count of
  ``params`` leaves (``jax.eval_shape`` of the init) for ``tiny``,
  ``tiny_lidar`` and ``tiny_pp``;
- each kernel wrapper, counted: K1's forward, d/dfeat and d/dW at
  2 * Cin * Cout a hit of the table each walks (computed here from the
  tables), K2's forward and backward at 4 k^2 C and 10 k^2 C a pixel, with
  none of their plain versions' own matmuls counted;
- the count of a whole forward is the same run to run, and ``--train``
  counts more than the forward; a train step with ``lap_impl=auction``
  counts what the scipy step counts (the auction is left out);
- with counting off the wrappers dispatch exactly the operators they did
  before a counted run (no counted operator among them).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from deepinteraction_tpu import configs as jcfg
from deepinteraction_tpu.models.detector import DeepInteraction as JModel
from deepinteraction_tpu.utils.testing import make_synthetic_batch
from deepinteraction_tpu_torch.configs import apply_overrides
from deepinteraction_tpu_torch.ops import flops
from deepinteraction_tpu_torch.ops import local_attention as la
from deepinteraction_tpu_torch.ops import subm_conv as smc
from deepinteraction_tpu_torch.tools import benchmark, get_flops
from deepinteraction_tpu_torch.tools.test import CONFIGS

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["tiny", "tiny_lidar", "tiny_pp"])
def test_params_equal_jax(name, capsys):
    cfg = getattr(jcfg, f"{name}_config")()
    model = JModel(cfg.model, cfg.data.padded_img_shape)
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_batch(cfg, b=1, with_gt=False).items()}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    record = get_flops.main([name, "--device", "cpu"])
    assert record["params"] == want
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"params: {want / 1e6:.2f} M"
    assert out[1] == f"flops:  {record['flops'] / 1e9:.2f} GFLOPs per forward"


def _table(rng, ko, kin, taps, hit_rate):
    nbr = rng.integers(0, kin, (ko, taps)).astype(np.int32)
    nbr[rng.random((ko, taps)) >= hit_rate] = kin
    return torch.from_numpy(nbr)


def test_k1_counted_by_its_table():
    rng = np.random.default_rng(0)
    kin, ko, taps, cin, cout = 50, 40, 27, 8, 12
    nbr = _table(rng, ko, kin, taps, 0.3)
    inv = _table(rng, kin, ko, taps, 0.3)
    valid = torch.from_numpy(rng.random(ko) < 0.8)
    feats = torch.randn(kin, cin, requires_grad=True)
    w = torch.randn(taps, cin, cout, requires_grad=True)

    def fwd_bwd():
        out = smc.subm_conv_gemm(feats, nbr, w, valid, inv)
        out.sum().backward()
        return out

    _, total, by_op = flops.count_flops(fwd_bwd)
    hits = int(((nbr < kin) & valid[:, None]).sum())
    assert by_op["di_port.subm_conv_gemm"] == 2 * cin * cout * hits
    assert by_op["di_port.subm_conv_dgrad"] == 2 * cin * cout * int((inv < ko).sum())
    assert by_op["di_port.subm_conv_wgrad"] == 2 * cin * cout * int((nbr < kin).sum())
    assert total == sum(by_op.values()) and set(by_op) == {
        "di_port.subm_conv_gemm", "di_port.subm_conv_dgrad", "di_port.subm_conv_wgrad"}
    assert not flops.counting


def test_k2_counted_per_pixel():
    shape, k = (2, 6, 7, 8), 5
    torch.manual_seed(0)
    q, kk, v, dout = (torch.randn(shape) for _ in range(4))
    runs = []
    for counted in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (q, kk, v)]

        def fwd_bwd():
            out = la.local_attn_fwd(*leaves, k)
            out.backward(dout)
            return out

        if counted:
            out, total, by_op = flops.count_flops(fwd_bwd)
        else:
            out = fwd_bwd()
        runs.append([out.detach()] + [t.grad for t in leaves])
    pixels = 2 * 6 * 7
    assert by_op == {"di_port.local_attn_fwd": 4 * k * k * 8 * pixels,
                     "di_port.local_attn_bwd": 10 * k * k * 8 * pixels}
    assert total == sum(by_op.values())
    # the counted route gives the plain route's output and gradients
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_forward_count_repeats_and_train_counts_more(capsys):
    a = get_flops.main(["tiny_lidar", "--device", "cpu"])
    b = get_flops.main(["tiny_lidar", "--device", "cpu"])
    train = get_flops.main(["tiny_lidar", "--device", "cpu", "--train"])
    assert a["flops"] == b["flops"] and a["flops_by_op"] == b["flops_by_op"]
    assert a["flops_by_op"]["di_port.subm_conv_gemm"] > 0
    assert train["flops"] > a["flops"] and train["per"] == "step"
    assert train["flops_by_op"]["di_port.subm_conv_wgrad"] > 0
    assert capsys.readouterr().out.splitlines()[-2].endswith("GFLOPs per step")


def test_auction_step_counts_what_the_callback_step_counts():
    """``lap_impl=auction``: the auction does no useful multiply and is left
    out of the count, so a ``tiny_lidar`` train step counts exactly what
    the scipy step counts: the matching changes no counted operation."""
    counts = {}
    for impl in ("callback", "auction"):
        cfg = apply_overrides(CONFIGS["tiny_lidar"](), {"model.assigner.lap_impl": impl})
        model = benchmark.build_model(cfg, True, "cpu")
        run = benchmark.make_run(cfg, model, benchmark.synthetic_batches(cfg, 1, 2, True, "cpu"), True, "cpu")
        _, counts[impl], _ = flops.count_flops(run, 0)
    assert counts["auction"] == counts["callback"] > 0


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_counting_off_leaves_the_launch_path_unchanged():
    cfg = CONFIGS["tiny_lidar"]()
    model = benchmark.build_model(cfg, False, "cpu")
    run = benchmark.make_run(cfg, model, benchmark.synthetic_batches(cfg, 1, 1, False, "cpu"), False, "cpu")

    def recorded():
        with _Record() as rec:
            run(0)
        return rec.ops

    before = recorded()
    flops.count_flops(run, 0)
    after = recorded()
    assert not flops.counting
    assert before == after and not any("di_port" in op for op in before)
    with flops.counting_kernels(), _Record() as rec:
        run(0)
    assert sum("di_port.subm_conv_gemm" in op for op in rec.ops) == 21
