"""The trainer's profiler capture (``TrainerConfig.profile_dir``, ``train
--profile-dir``), ``utils/timing.py`` and ``tools/summarize_trace.py``: a
run writes a torch.profiler Chrome trace of its steady micro-steps, and
the summary reads it (host operations here; on the card the same file
holds the kernels, as the hand-made device trace below does)."""

import glob
import json
import os

import torch

from rag_snvbert_tpu_torch.cli.main import main
from rag_snvbert_tpu_torch.tools import summarize_trace
from rag_snvbert_tpu_torch.utils import timing
from test_torch_cli_serve import MODEL, _train_argv, files  # noqa: F401
from test_torch_modules import torch_one_thread  # noqa: F401
from test_torch_train import _trainer


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("ph") == "X"}


def test_trainer_profile_dir_writes_a_trace_of_steady_steps(tmp_path):
    prof = str(tmp_path / "prof")
    tr = _trainer(tmp_path / "run", 1, profile_dir=prof, profile_steps=2)
    steps = []
    real = tr.optimizer.step
    tr.optimizer.step = lambda: steps.append(1) or real()
    tr.fit()
    files_ = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert files_ == [tr.trace_path]
    names = _trace_names(tr.trace_path)
    # two micro-steps' backward passes and matmuls are on the trace
    assert "aten::mm" in names and any("Backward" in n for n in names)
    text = summarize_trace.summarize(
        summarize_trace.load_events(tr.trace_path), top=50)
    assert "== host" in text and "aten::mm" in text
    assert len(steps) == 4          # the capture does not change the run


def test_a_short_epoch_closes_the_trace(tmp_path):
    """Fewer steps than profile_steps after the first: the trace ends with
    the epoch (JAX trainer.py:431-432)."""
    prof = str(tmp_path / "prof")
    tr = _trainer(tmp_path / "run", 1, profile_dir=prof, profile_steps=50)
    tr.fit()
    assert tr.trace_path and os.path.exists(tr.trace_path)


def test_train_profile_dir_flag_writes_the_trace(files, tmp_path, capsys):
    prof = str(tmp_path / "prof")
    main(_train_argv(files, str(tmp_path / "run"), *MODEL, "--profile-dir",
                     prof, "--profile-steps", "1"))
    assert "best" in json.loads(capsys.readouterr().out.splitlines()[-1])
    summarize_trace.main([prof, "--top", "5"])
    out = capsys.readouterr()
    assert "trace:" in out.err and "== host" in out.out


def test_summary_of_a_device_trace_ranks_kernels_and_classes():
    """A trace in torch's Chrome layout with a CUDA stream: kernels by
    accumulated time, their share, and their classes without template
    arguments."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "GPU 0"}},
          {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
           "args": {"name": "stream 7"}},
          {"ph": "M", "name": "process_name", "pid": 99,
           "args": {"name": "python"}}]
    t = 0.0
    for name, dur, n in (("void attention_fwd_kernel<64>(float*)", 230., 3),
                         ("void attention_fwd_kernel<128>(float*)", 100., 1),
                         ("l2_partial_dots", 500., 1),
                         ("l2_select", 80., 1)):
        for _ in range(n):
            ev.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                       "name": name, "ts": t, "dur": dur})
            t += dur + 10
    ev.append({"ph": "X", "cat": "cpu_op", "pid": 99, "tid": 1,
               "name": "aten::mm", "ts": 0.0, "dur": 400.0})
    text = summarize_trace.summarize(ev, top=10, classes=True)
    lines = text.splitlines()
    dev = next(i for i, line in enumerate(lines) if "== device" in line)
    assert "device GPU 0 / stream 7: 1.370 ms busy" in lines[dev]
    assert lines[dev + 2].startswith("void attention_fwd_kernel<64>")
    assert lines[dev + 3].startswith("l2_partial_dots")
    cls = lines[lines.index("by kernel class:") + 1]
    assert cls.startswith("attention_fwd_kernel") and " 4 " in cls
    assert "== host python / 1" in text
    assert text.index("== device") < text.index("== host")
    for name, cls in (("void ns::l2_select<float, 8>(int)", "l2_select"),
                      ("void (anonymous namespace)::attention_bwd_dq_kernel"
                       "<128>(CUtensorMap_st)", "attention_bwd_dq_kernel"),
                      ("void at::native::(anonymous namespace)::"
                       "layer_norm_kernel<float>(int)", "layer_norm_kernel"),
                      ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN",
                       "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN")):
        assert summarize_trace.kernel_class(name) == cls


def test_timing_utilities(tmp_path):
    """``span`` is the shared no-op off the profiler and a named region of
    the trace ``profile_trace`` writes while it records."""
    off = timing.span("trainer.epoch")
    assert off is timing.span("imputer.call")
    with off:
        pass
    with timing.profile_trace(str(tmp_path / "t"), device="cpu") as prof:
        assert timing.span("my.region") is not off
        with timing.span("my.region"):
            torch.ones(3).sum()
    assert prof is not None
    (path,) = glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    assert "my.region" in _trace_names(path)
    assert timing.span("my.region") is off


def test_device_idle_by_program_span():
    """The operator view: the device's idle holes over the traced range,
    each instant given to the innermost program span on the launching
    thread (the one with the most CUDA runtime calls), the rest to no
    span; spans of another thread and other host events are not program
    spans there."""
    ev = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k",
           "ts": t, "dur": 10.0} for t in (0.0, 20.0, 60.0)]
    host = [("trainer.epoch", 0.0, 55.0), ("trainer.window_context", 12.0,
                                           4.0),
            ("dispatch.chunk", 16.0, 9.0), ("trainer.batch_wait", 35.0, 5.0),
            ("trainer.batch_wait", 40.0, 5.0), ("aten::mm", 30.0, 20.0)]
    for name, ts, dur in host:
        ev.append({"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 2,
                   "name": name, "ts": ts, "dur": dur})
    ev += [{"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 2,
            "name": "cudaLaunchKernel", "ts": t, "dur": 1.0}
           for t in (0.0, 19.0, 59.0)]
    ev.append({"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 3,
               "name": "imputer.call", "ts": 0.0, "dur": 70.0})
    device = [(e["ts"], e["ts"] + e["dur"]) for e in ev
              if e["cat"] == "kernel"]
    spans = [(ts, ts + dur, n) for n, ts, dur in host if "." in n]
    got = summarize_trace.idle_by_span(device, spans, 0.0, 70.0)
    # holes 10-20 and 30-60: epoch 10-12, 30-35 and 45-55, context 12-16,
    # chunk 16-20 (it ends inside the busy 20-30), the waits 35-45 back to
    # back, no span 55-60
    assert got == {"trainer.epoch": 2.0 + 5.0 + 10.0,
                   "trainer.window_context": 4.0, "dispatch.chunk": 4.0,
                   "trainer.batch_wait": 10.0,
                   summarize_trace.NO_SPAN: 5.0}
    assert sum(got.values()) == 40.0
    text = summarize_trace.idle_table(ev)
    lines = text.splitlines()
    assert "device idle by program span: 0.040 ms of 0.070 ms (57.14%)" \
        in text
    assert lines[3].startswith("trainer.epoch") and "24.286" in lines[3]
    assert "imputer.call" not in text
    assert summarize_trace.idle_table(
        [e for e in ev if e["cat"] != "kernel"]) == ""
