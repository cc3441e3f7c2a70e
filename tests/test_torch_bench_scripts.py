"""The port's part benches (jolineedle_tpu_torch/scripts/bench_*.py and
analyze_trace.py) against the JAX package's scripts of the same names under
``scripts/``: the same shapes, stage lists and output forms, each run in its
small mode on the CPU (where the kernel wrappers run their plain versions);
``analyze_trace`` on a synthetic Chrome trace whose class totals are known.
"""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from jolineedle_tpu_torch import bench
from jolineedle_tpu_torch.scripts import (analyze_trace, bench_attention, bench_embedder_stages,
                                          bench_pallas_embedder, bench_rollout_parts)

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

JAX_SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _jax_tree(name):
    return ast.parse((JAX_SCRIPTS / name).read_text())


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_rollout_parts_small_prints_the_jax_line(monkeypatch, capsys):
    """The JAX script's parts and keys (read from its source), each part's
    line in its form, at the small config on the CPU."""
    source = (JAX_SCRIPTS / "bench_rollout_parts.py").read_text()
    jax_keys = set(re.findall(r'results\["(\w+)"\]', source))
    monkeypatch.setenv("BENCH_SMALL", "1")
    monkeypatch.setenv("BENCH_PARTS_ITERS", "2")
    got = bench_rollout_parts.main([], device="cpu")
    out = capsys.readouterr().out
    for label in ("dispatch", "embed", "decode", "env", "scan20"):
        assert re.search(rf"^{label}\s+\d+\.\d{{3}} ms/iter  \[cpu\]$", out, re.M), label
    (line,) = _json_lines(out)
    assert set(line) == jax_keys | {"card"} and line["card"] == "cpu"
    assert line["batch"] == 2 and line["embedder"] == "yolox-nano"
    assert all(got[k] > 0 for k in jax_keys if k.endswith("_ms"))
    assert got["sum_parts_ms"] == got["decode_ms"] + got["env_ms"]


def _literal_list(tree, target):
    """The literal list assigned to ``target`` in the JAX script (both arms of
    a conditional), in source order."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == target
                                                for t in node.targets):
            value = node.value
            if isinstance(value, ast.IfExp):
                return ast.literal_eval(value.body), ast.literal_eval(value.orelse)
            return ast.literal_eval(value)
    raise AssertionError(f"no {target} = [...] in the JAX script")


def test_attention_sweep_is_the_jax_scripts():
    small, full = _literal_list(_jax_tree("bench_attention.py"), "shapes")
    assert bench_attention.SMALL_SHAPES == small and bench_attention.SHAPES == full
    assert {d for *_, d in full} == {64, 128}


def test_attention_small_row(monkeypatch, capsys):
    """BENCH_ATTN_SMALL's one shape: the JAX script's line form (SDPA in XLA's
    place), and on the CPU the wrapper's plain version, so no error."""
    monkeypatch.setenv("BENCH_ATTN_SMALL", "1")
    monkeypatch.setenv("BENCH_ATTN_ITERS", "2")
    (row,) = bench_attention.main([], device="cpu")
    out = capsys.readouterr().out
    assert re.search(r"^B2 H2 T256 D128: flash +\d+\.\d{3} ms \( *\d+\.\d{2} TF/s\) \| sdpa +"
                     r"\d+\.\d{3} ms \( *\d+\.\d{2} TF/s\) \| max\|err\| 0\.0000 \| speedup +"
                     r"\d+\.\d{2}x  \[cpu\]$", out, re.M), out
    assert row["shape"] == [2, 2, 256, 128] and row["max_abs_err"] == 0.0
    assert row["speedup"] == pytest.approx(row["sdpa_ms"] / row["flash_ms"])
    assert row["card"] == "cpu"


def _jax_stage_lists():
    """{function: [(name, (H, C, K, kind, stride), count)]}: the JAX script's
    ``make_stage`` tuples in each of its functions, in source order."""
    lists = {}
    for fn in _jax_tree("bench_embedder_stages.py").body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Tuple) and len(node.elts) == 3
                    and isinstance(node.elts[1], ast.Call)
                    and getattr(node.elts[1].func, "id", None) == "make_stage"):
                H, C, K, kind, *stride = (ast.literal_eval(a) for a in node.elts[1].args)
                lists.setdefault(fn.name, []).append(
                    (ast.literal_eval(node.elts[0]), (H, C, K, kind, *(stride or [1])),
                     ast.literal_eval(node.elts[2])))
    return lists


def test_embedder_stage_lists_are_the_jax_scripts():
    lists = _jax_stage_lists()
    assert lists["main"] == bench_embedder_stages.NANO_STAGES
    assert lists["yolox_s_stages"] == bench_embedder_stages.S_STAGES


@pytest.mark.parametrize("variant", ["yolox-nano", "yolox-s"])
def test_embedder_stages_small(variant, capsys):
    """Every stage at B = 1 on the CPU: one JSON line each, then the sums; a
    stage takes the kernel exactly where the model's module launches one
    (stride-1 DWConvs, stride-1 dense 3x3s)."""
    rows = bench_embedder_stages.main(["--batch", "1", "--reps", "1", "--variant", variant],
                                      device="cpu")
    lines = _json_lines(capsys.readouterr().out)
    assert lines == rows
    *stages, summary = rows
    want = bench_embedder_stages.STAGES[variant]
    assert [r["stage"] for r in stages] == [name for name, _, _ in want]
    for r, (_, (H, C, K, kind, stride), count) in zip(stages, want):
        assert r["route"] == ("kernel" if kind in ("dense3x3", "dwblock") and stride == 1
                              else "pytorch"), r["stage"]
        assert r["count"] == count and r["card"] == "cpu"
        assert ("tflops_per_s" in r) == (kind in ("dense3x3", "pw1x1"))
    assert summary["sum_us"] == pytest.approx(sum(r["total_us"] for r in stages), abs=1.0)
    assert summary["variant"] == variant and summary["batch"] == 1


def test_pallas_embedder_small(capsys):
    """The JAX script's four stage shapes (read from its source), one JSON
    line each at B = 1 on the CPU: the wrapper's plain version against the
    float32 plain version on the bf16 input, within bf16's rounding."""
    jax_stages = _literal_list(_jax_tree("bench_pallas_embedder.py"), "stages")
    assert bench_pallas_embedder.STAGES == jax_stages
    rows = bench_pallas_embedder.main(["--batch", "1", "--iters", "1"], device="cpu")
    assert _json_lines(capsys.readouterr().out) == rows
    assert [r["stage"] for r in rows] == [f"{hw}x{hw}x{c}" for hw, c in jax_stages]
    for r in rows:
        assert set(r) == {"stage", "kernel_us", "cudnn_us", "ratio", "kernel_gflops",
                          "max_abs_err", "card"}
        assert r["max_abs_err"] < 3e-2 and r["card"] == "cpu"


# A synthetic trace: device events of every class (two overlapping on two
# streams), host events that widen the window to [0, 200) us.
SYNTHETIC = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 200},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::flash_fwd_kernel<float, 16,"
     " true>(Params)", "ts": 10, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::dwblock_kernel<bf16>", "ts": 20,
     "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32",
     "ts": 40, "dur": 30},
    {"ph": "X", "cat": "kernel", "name": "nvjet_tst_64x8_64x16_4x1_v_bz_TNN", "ts": 60, "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4,"
     " at::native::silu_kernel>", "ts": 100, "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 4,"
     " direct_copy_kernel_cuda>", "ts": 105, "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel<512, 1>", "ts": 110,
     "dur": 4},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 120,
     "dur": 6},
    {"ph": "X", "cat": "kernel", "name": "nchwToNhwcKernel", "ts": 130, "dur": 2},
    {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4,"
     " at::native::silu_kernel>", "ts": 140, "dur": 5},
    {"ph": "i", "cat": "marker", "name": "instant", "ts": 300},
]
WANT_CLASSES = {"port kernels": 0.030, "convolution": 0.030, "gemm": 0.020,
                "elementwise": 0.010, "copy/memset": 0.011, "reduce": 0.004, "other": 0.002}


def test_analyze_trace_splits_a_known_trace(tmp_path, capsys):
    """Class totals, names within a class, the summed and the busy device
    time (the conv and the gemm overlap by 10 us) over the window."""
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "bench_trace.json").write_text(json.dumps({"traceEvents": SYNTHETIC}))
    out = analyze_trace.main([str(tmp_path), "--top", "2"])
    assert out["by_class"] == pytest.approx(WANT_CLASSES)
    assert out["total_ms"] == pytest.approx(0.107)
    assert out["busy_ms"] == pytest.approx(0.097) and out["window_ms"] == pytest.approx(0.2)
    assert out["busy_pct"] == pytest.approx(48.5)
    silu = "void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel>"
    assert out["by_name"]["elementwise"] == {silu: [pytest.approx(0.010), 2]}
    text = capsys.readouterr().out
    assert "device busy: 0.097 ms of a 0.200 ms window (48.5 %)" in text
    assert re.search(r"^port kernels +0\.030 +28\.0$", text, re.M)
    assert "port kernels: top 2 of 2 kernels" in text


def test_analyze_trace_of_a_cpu_profile_refuses(tmp_path):
    """The bench's profiled pass on the CPU writes a Chrome trace with no
    device event: the analysis says so instead of printing empty classes."""
    trainer, _, images, boxes, *_ = bench.build(True, env={}, device="cpu")
    bench.bench_rollout(trainer, images, boxes, iters=1, repeats=1, profile_dir=str(tmp_path))
    assert (tmp_path / "bench_trace.json").is_file()
    with pytest.raises(SystemExit, match="no device events"):
        analyze_trace.main([str(tmp_path)])


def test_analyze_trace_imports_neither_torch_nor_jax():
    tree = ast.parse(Path(analyze_trace.__file__).read_text())
    imported = {alias.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for alias in (node.names if isinstance(node, ast.Import)
                              else [ast.alias(node.module or "")])}
    assert imported <= {"__future__", "argparse", "collections", "json", "pathlib"}
