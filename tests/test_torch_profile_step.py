"""``python -m mpc_tpu_torch.profile_step <cell>`` reaches a profiler for
every cell of ``bench.CELLS`` (the sharded cells through ``profile_mesh``,
not a closed loop, whose ``ClosedLoop`` reads fields a ``MeshCell`` lacks),
with the profilers replaced so that nothing runs here; and ``profile_mesh``
turns a runner's timed call into wall, device busy, idle share and
kernels, the profiler and its averages replaced too.
"""

import contextlib
import json

import pytest
import torch

from mpc_tpu_torch import bench, profile_step

torch.set_num_threads(1)

INFO = {"nvidia_smi": "a card, 700.00 W", "name": "a card",
        "power_limit": "700.00 W"}
PROFILERS = ("profile_unfused", "profile_suite", "profile_two_car",
             "profile_mesh", "profile_closed_loop")


@pytest.mark.parametrize("name", list(bench.CELLS))
def test_every_cell_reaches_a_profiler(name, monkeypatch, capsys):
    seen = []
    for fn in PROFILERS:
        def fake(cell, fn=fn):
            seen.append((fn, cell))
            return {"cell": cell.name}
        monkeypatch.setattr(profile_step, fn, fake)
    monkeypatch.setattr(profile_step, "gpu_info", lambda: INFO)
    profile_step.main([name])
    cell = bench.CELLS[name]
    assert [c for _, c in seen] == [cell]
    want = ("profile_mesh" if isinstance(cell, bench.MeshCell) else
            "profile_unfused" if name in profile_step.UNFUSED else
            "profile_suite" if isinstance(cell, bench.SuiteCell) else
            "profile_two_car" if isinstance(cell, bench.TwoCarCell) else
            "profile_closed_loop")
    assert seen[0][0] == want
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["profile"] == {"cell": name, "device": "a card",
                               "power_limit": "700.00 W"}


@pytest.mark.parametrize("name", ["mesh_dp", "mesh_lqt", "mesh_ilqr"])
def test_profile_mesh_profiles_one_timed_call(name, monkeypatch):
    calls = []

    def runner(cell, timed_call=contextlib.nullcontext):
        calls.append((cell.n_warmup, cell.n_steps, timed_call))
        with timed_call():
            pass
        return {"times_s": [0.5 if len(calls) == 1 else 0.6], "world": 1,
                "backend": "nccl", "mesh": [1, 1],
                "inner_iterations_run": 60, "inner_iters_mean": 4.0}

    entered = []

    @contextlib.contextmanager
    def fake_profile(activities):
        entered.append(activities)
        yield "prof"

    monkeypatch.setitem(bench.MESH_RUNNERS, name, runner)
    monkeypatch.setattr(profile_step, "profile", fake_profile)
    monkeypatch.setattr(profile_step, "device_time",
                        lambda prof: (100.0, 1234))
    r = profile_step.profile_mesh(bench.CELLS[name])
    assert [c[:2] for c in calls] == [(1, 1), (1, 1)]
    assert calls[0][2] is contextlib.nullcontext and len(entered) == 1
    assert r["wall_ms"] == 500.0 and r["wall_ms_under_profiler"] == 600.0
    assert r["device_busy_ms"] == 100.0 and r["device_kernels"] == 1234
    assert r["idle_share"] == pytest.approx(0.8)
    assert r["cell"] == name
