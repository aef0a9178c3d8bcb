"""Supervisor tests for bench.py.

bench.py is a supervisor: the parent never imports jax, each stage runs
in its own child process, and a child that hangs (no output) or overruns
its cap is killed while the run continues.  These tests prove the
mechanism with a forced hang: a stage that sleeps forever must cost ONE
stage, not the run.  They also pin that a stage using JAX refuses to run
without a GPU: there is no CPU fallback.

Reference robustness analogue: the reference surfaces per-trajectory
failures as values rather than aborting the batch (reference
``src/trajectories/trajectory_fit.rs`` outcome enum); here the same
errors-as-data posture is applied to the bench harness itself.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(stages, extra_env=None, timeout=300, env=None):
    if env is None:
        env = dict(os.environ)
        env.setdefault("JAX_PLATFORMS", "cpu")
    else:
        env = dict(env)
    env["OUTFIT_BENCH_STAGES"] = stages
    env.pop("OUTFIT_BENCH_FORCE_WEDGE", None)
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
    )


def _last_json_line(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert lines, "no stdout lines at all"
    return json.loads(lines[-1])


def test_supervisor_kills_wedged_stage_and_continues():
    """A stage that never produces output is SIGKILLed at the stall
    timeout and the NEXT stage still runs to completion, leaving rc=0 and
    a valid final metric line."""
    # stall 20s, not smaller: the stall clock starts at spawn, so the
    # window must also cover the NEXT stage's interpreter startup on a
    # loaded machine (a 6s window once killed the healthy noop stage
    # while a parallel 8-device XLA compile thrashed the host)
    p = _run_bench(
        "wedge,noop",
        {"OUTFIT_BENCH_STALL_S": "20", "OUTFIT_BENCH_BUDGET_S": "120"},
    )
    assert p.returncode == 0, f"rc={p.returncode}\n{p.stderr[-2000:]}"
    assert "KILLED" in p.stderr, p.stderr[-2000:]
    assert "wedge" in p.stderr
    last = _last_json_line(p.stdout)
    assert last["value"] == 1.0
    assert "noop" in last["metric"]
    # the wedge must not have produced a metric
    assert "wedge" not in last["metric"]


def test_force_wedge_env_and_failure_marker():
    """OUTFIT_BENCH_FORCE_WEDGE wedges any real stage by name; when NO
    stage completes the tail still ends with an explicit parseable
    failure-marker line and rc=3 (never an empty tail)."""
    p = _run_bench(
        "noop",
        {
            "OUTFIT_BENCH_FORCE_WEDGE": "noop",
            "OUTFIT_BENCH_STALL_S": "20",
            "OUTFIT_BENCH_BUDGET_S": "90",
        },
    )
    assert p.returncode == 3, f"rc={p.returncode}\n{p.stderr[-2000:]}"
    assert "FORCE_WEDGE" in p.stderr
    assert "KILLED" in p.stderr
    last = _last_json_line(p.stdout)
    assert last["value"] == 0.0
    assert "no measurement" in last["metric"]


def test_budget_skip_logging():
    """Stages whose historical cost exceeds the remaining budget are
    skipped (never started) with an explicit log line."""
    p = _run_bench("noop,prop-fallback", {"OUTFIT_BENCH_BUDGET_S": "30"})
    # noop (cost 2s) fits a 30s budget; prop-fallback (cost 60s) must not
    assert p.returncode == 0, f"rc={p.returncode}\n{p.stderr[-2000:]}"
    assert "SKIP stage prop-fallback" in p.stderr
    last = _last_json_line(p.stdout)
    assert "noop" in last["metric"]


@pytest.mark.gpu
def test_supervisor_recovers_real_jax_stage_after_wedge(gpu_env):
    """After killing a wedged stage, a REAL jax stage (two-body
    propagation) still compiles and completes on the GPU in a fresh
    process in the same supervisor run."""
    p = _run_bench(
        "wedge,prop-fallback",
        {"OUTFIT_BENCH_BUDGET_S": "420"},
        timeout=500, env=gpu_env,
    )
    assert p.returncode == 0, f"rc={p.returncode}\n{p.stderr[-2000:]}"
    assert "KILLED" in p.stderr
    last = _last_json_line(p.stdout)
    assert last["unit"] == "steps/sec/chip"
    assert last["value"] > 0


def test_jax_stage_fails_without_gpu(tmp_path):
    """A stage that uses JAX exits non-zero on the CPU backend, before
    any work and without a result line: there is no CPU fallback."""
    rpath = tmp_path / "result.jsonl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--stage",
         "prop-fallback", "--result-file", str(rpath)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr, p.stderr[-2000:]
    assert not rpath.exists() or rpath.read_text() == ""


def test_cap_kill_is_not_a_wedge_and_gets_one_cap_retry():
    """A stage that keeps producing output but overruns its cap is a
    SLOW stage, not a wedge: the supervisor must kill it at the cap,
    classify it as progressing, grant exactly ONE retry from the cap
    pool (warm-compile-cache rationale), and never log the wedge-retry
    message for it — then continue to the next stage and exit rc=0."""
    p = _run_bench(
        "slow,noop",
        {"OUTFIT_BENCH_STALL_S": "240", "OUTFIT_BENCH_BUDGET_S": "120"},
        timeout=200,
    )
    assert p.returncode == 0, f"rc={p.returncode}\n{p.stderr[-2000:]}"
    assert p.stderr.count("cap overrun was still progressing") == 1, (
        p.stderr[-3000:]
    )
    assert "wedge-retrying" not in p.stderr
    # killed at the cap on the first attempt AND on the single retry
    assert p.stderr.count("exceeded its 10s cap") == 2, p.stderr[-3000:]
    last = _last_json_line(p.stdout)
    assert "noop" in last["metric"]


def test_flush_tail_never_leaves_an_empty_tail():
    """_flush_tail — shared by the final, watchdog, and signal exit paths
    (the per-stage cap normally beats the watchdog by design; the
    watchdog is the parent-hang last resort) — must always print a
    parseable JSON line: the ranked best, else the last secondary
    metric, else the explicit failure marker."""
    code = r"""
import json, sys
sys.path.insert(0, %r)
import bench

# 1. nothing at all -> failure marker, returns False
assert bench._flush_tail("t1") is False

# 2. a secondary (extra) metric exists -> it is re-printed, True
bench._EXTRAS_PRINTED["k"] = {
    "metric": "secondary-only", "value": 7.0, "unit": "x",
}
assert bench._flush_tail("t2") is True

# 3. a ranked result outranks the extra fallback
bench.REPORTER.report({
    "metric": "ranked-best", "value": 1.0, "unit": "y",
}, tier=2)
assert bench._flush_tail("t3") is True
print("UNIT-DONE")
"""
    p = subprocess.run(
        [sys.executable, "-c", code % REPO],
        capture_output=True, text=True, cwd=REPO, timeout=60,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [json.loads(ln) for ln in p.stdout.strip().splitlines()
             if ln.strip().startswith("{")]
    # marker, then the secondary, then ranked (printed on report) + flush
    assert "no measurement" in lines[0]["metric"]
    assert lines[1]["metric"] == "secondary-only"
    assert lines[-1]["metric"] == "ranked-best"
