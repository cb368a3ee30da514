"""The trace tools (``tools/trace_model.py``, ``tools/analyze_trace.py``),
on the CPU:

- ``trace_model tiny --device cpu --iters 1`` writes a Chrome trace and
  prints the JAX tool's lines in its order (``compile+run``, two ``warm``,
  ``trace written to``, ``steady-state``);
- ``analyze_trace`` over that trace falls back to the host's operator
  lanes, says so, and its category and scope sums each add up to its
  total, the scopes being the model's top-level modules;
- ``analyze_trace`` over a hand-written trace with GPU kernel events,
  their launches' correlation ids and nested ``record_function`` ranges
  gives the expected sums by category, by scope and by kernel, per run.
"""

import contextlib
import gzip
import io
import json
import re

import pytest
import torch

from deepinteraction_tpu_torch.tools import analyze_trace, trace_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """(outdir, trace path, printed lines) of one ``trace_model`` run."""
    outdir = str(tmp_path_factory.mktemp("trace"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = trace_model.main(["tiny", "--device", "cpu", "--iters", "1", "--outdir", outdir])
    return outdir, path, out.getvalue().strip().splitlines()


def test_trace_model_prints_the_jax_lines(cpu_trace):
    outdir, path, lines = cpu_trace
    pats = [r"compile\+run: \d+\.\ds", r"warm: \d+\.\d{3}s", r"warm: \d+\.\d{3}s",
            rf"trace written to {re.escape(outdir)}", r"steady-state: \d+\.\d ms/iter"]
    assert len(lines) == len(pats), lines
    for line, pat in zip(lines, pats):
        assert re.fullmatch(pat, line), (line, pat)
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "ProfilerStep#0" for e in events) == 1


def test_analyze_cpu_trace(cpu_trace, capsys):
    res = analyze_trace.main([cpu_trace[0], "--ops"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("no GPU lanes in the trace")
    assert json.loads(out[-1]) == json.loads(json.dumps(res))
    assert res["runs"] == 1 and res["total_ms"] > 0
    for key in ("by_category_ms_per_run", "by_scope_ms_per_run"):
        assert sum(res[key].values()) == pytest.approx(res["ms_per_run"], rel=1e-9)
    assert {"img_backbone", "pts_middle_encoder", "imgpts_neck", "pts_bbox_head"} <= set(res["by_scope_ms_per_run"])
    assert res["by_category_ms_per_run"]["cuDNN conv"] > 0 and res["by_category_ms_per_run"]["GEMM"] > 0


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _fixture_trace():
    """Two runs on one host thread (pid 1, tid 10) launching onto one GPU
    stream (pid 0, tid 7); kernel durations in us."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}}]
    corr = 0
    kernels = [  # (scope, kernel name, category, us)
        ("pts_middle_encoder", "void subm_conv_gemm_kernel<Tile128>(float const*)", "port K1 (subm_conv)", 300),
        ("pts_middle_encoder", "void subm_conv_gemm_kernel<Tile16>(float const*)", "port K1 (subm_conv)", 100),
        ("img_backbone", "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "cuDNN conv", 500),
        ("img_backbone", "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
         "elementwise/reduce", 40),
        ("imgpts_neck", "void local_attn_fwd_kernel<9, 4>(float const*)", "port K2 (local_attn)", 200),
        ("imgpts_neck", "ampere_sgemm_128x64_nn", "GEMM", 60),
        (None, "Memcpy HtoD (Pageable -> Device)", "copy/memset", 20),
        ("pts_bbox_head", "nvjpeg_idct_kernel", "other (nvJPEG, ...)", 10),
    ]
    for run in range(2):
        t0 = run * 10000
        ev.append(_x("user_annotation", f"ProfilerStep#{run}", 1, 10, t0, 9000))
        spans = {"pts_middle_encoder": (t0 + 100, 1000), "img_backbone": (t0 + 1200, 1000),
                 "imgpts_neck": (t0 + 2300, 1000), "pts_bbox_head": (t0 + 3400, 1000)}
        for name, (ts, dur) in spans.items():
            ev.append(_x("user_annotation", name, 1, 10, ts, dur))
        # a nested range inside a scope: the innermost names the launch
        ev.append(_x("user_annotation", "i2p", 1, 10, t0 + 2310, 20))
        for i, (scope, name, cat, us) in enumerate(kernels):
            corr += 1
            ts = spans[scope][0] + 50 + i if scope else t0 + 5000
            if name.startswith("void local_attn"):
                ts = t0 + 2320  # inside the nested i2p range
            ev.append(_x("cpu_op", "aten::something", 1, 10, ts - 1, 3, **{"External id": corr}))
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", 1, 10, ts, 2, correlation=corr))
            kcat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
            ev.append(_x(kcat, name, 0, 7, t0 + 6000 + 100 * i, us, correlation=corr, stream=7))
    return {"traceEvents": ev}, kernels


def test_analyze_fixture_trace(tmp_path, capsys):
    trace, kernels = _fixture_trace()
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    res = analyze_trace.main([str(tmp_path), "--ops", "--top", "50"])
    capsys.readouterr()
    assert res["lanes"] == "device kernels" and res["runs"] == 2
    assert res["ms_per_run"] == pytest.approx(sum(k[3] for k in kernels) / 1e3)
    want_cat, want_scope = {}, {}
    for scope, name, cat, us in kernels:
        want_cat[cat] = want_cat.get(cat, 0) + us / 1e3
        scope = "i2p" if name.startswith("void local_attn") else (scope or analyze_trace.NO_SCOPE)
        want_scope[scope] = want_scope.get(scope, 0) + us / 1e3
    assert res["by_category_ms_per_run"] == pytest.approx(want_cat)
    assert res["by_scope_ms_per_run"] == pytest.approx(want_scope)
    assert res["window_ms_per_run"] == pytest.approx(9.0) and res["busy_share"] == pytest.approx(1.23 / 9.0)
    launches = res["port_launches_per_run"]
    assert launches["subm_conv_gemm"] == 2 and launches["local_attn_fwd"] == 1 and launches["local_attn_bwd_key"] == 0
    assert res["top_ops"][0] == [kernels[2][1], 0.5, 1]
    assert analyze_trace.main([str(tmp_path), "--iters", "1"])["ms_per_run"] == pytest.approx(2 * 1.23)


def _with_program_spans(trace):
    """The fixture trace plus program spans on the main thread, two
    launches from a second thread (tid 11, as the autograd engine's) inside
    ``di.train.backward``, one of them a ``cuLaunchKernel``, and a span on
    that thread."""
    ev = list(trace["traceEvents"])
    for run in range(2):
        t0 = run * 10000
        corr = 1000 + run
        ev += [
            _x("cpu_op", "di.sparse_encoder", 1, 10, t0 + 90, 1020),
            _x("cpu_op", "di.sparse.tables", 1, 10, t0 + 100, 40),
            _x("cpu_op", "di.sync.copy", 1, 10, t0 + 4990, 20),
            _x("cpu_op", "di.train.backward", 1, 10, t0 + 5500, 1000),
            _x("cpu_op", "di.sync.mask.grad", 1, 11, t0 + 5590, 20),
            _x("cuda_runtime", "cudaLaunchKernel", 1, 11, t0 + 5600, 2, correlation=corr),
            _x("kernel", "void at::native::index_put_kernel", 0, 7, t0 + 7000, 50, correlation=corr, stream=7),
            # a cuLaunchKernel, as cuDNN and cuBLAS make some
            _x("cuda_driver", "cuLaunchKernel", 1, 11, t0 + 5700, 2, correlation=corr + 10),
            _x("kernel", "cudnn_dgrad_kernel", 0, 7, t0 + 7100, 30, correlation=corr + 10, stream=7),
        ]
    return {"traceEvents": ev}


def test_analyze_fixture_program_spans(tmp_path, capsys):
    trace = _with_program_spans(_fixture_trace()[0])
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    res = analyze_trace.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "by program span" in out and "di.train.backward" in out
    spans = res.pop("by_span_per_run")
    # busy [6000, 6710], [7000, 7050] and [7100, 7130] after each run's start (us)
    assert spans["di.sparse_encoder"] == pytest.approx(
        {"count": 1, "host_ms": 1.02, "device_ms": 0.4, "copy_ms": 0, "memset_ms": 0, "idle_ms": 1.02})
    assert spans["di.sparse.tables"] == pytest.approx(
        {"count": 1, "host_ms": 0.04, "device_ms": 0, "copy_ms": 0, "memset_ms": 0, "idle_ms": 0.04})
    assert spans["di.sync.copy"] == pytest.approx(
        {"count": 1, "host_ms": 0.02, "device_ms": 0.02, "copy_ms": 0.02, "memset_ms": 0, "idle_ms": 0.02})
    assert spans["di.train.backward"] == pytest.approx(
        {"count": 1, "host_ms": 1.0, "device_ms": 0.08, "copy_ms": 0, "memset_ms": 0, "idle_ms": 0.5})
    assert spans["di.sync.mask.grad"] == pytest.approx(
        {"count": 1, "host_ms": 0, "device_ms": 0, "copy_ms": 0, "memset_ms": 0, "idle_ms": 0})
    # the spans move nothing else the tool prints
    bare = {"traceEvents": [e for e in trace["traceEvents"] if not e.get("name", "").startswith("di.")]}
    (tmp_path / "trace.json").write_text(json.dumps(bare))
    plain = analyze_trace.main([str(tmp_path)])
    capsys.readouterr()
    assert plain.pop("by_span_per_run") == {} and plain == res
