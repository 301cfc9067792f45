"""``python -m mpc_tpu_torch.examples.profile_config2 --device cpu``: one
point through the bench's closed-loop runner (``bench.run(cell, device)``)
on the CPU, at batch 2 with one timed step, no warm-up and caps of one
outer and one inner iteration, so that the runner's device branch runs
here; and each sweep's points as the JAX script's (examples/
profile_config2.py:141-169): tags, batches, caps, step sizes and the
backward pass, the parallel one unless ``--seq``.
"""

import argparse

import pytest
import torch

from mpc_tpu_torch.examples import profile_config2 as pc2

torch.set_num_threads(1)

JAX_KEYS = {"solves_per_s", "p50_step_s", "converged_fraction",
            "outer_mean", "outer_max", "inner_mean", "inner_max"}


def test_point_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(pc2, "N_WARM", 0)
    rows = pc2.main(["--batch", "2", "--n-steps", "1", "--max-outer", "1",
                     "--max-inner", "1", "--device", "cpu"])
    assert list(rows) == ["point"]
    r = rows["point"]
    assert JAX_KEYS <= set(r)
    assert (r["batch"], r["max_outer"], r["max_inner"]) == (2, 1, 1)
    assert r["parallel_backward"] and r["states_finite"]
    assert r["outer_max"] == 1 and r["inner_max"] == 1
    assert r["p50_step_s"] > 0
    assert capsys.readouterr().out.splitlines()[0].startswith("device: cpu")


def args(**kw):
    base = dict(sweep="point", seq=False, batch=256, max_outer=8,
                max_inner=30, n_alphas=0, n_steps=6)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("sweep, want", [
    ("point", [("point", 256, 8, 30, 6, True)]),
    ("batch", [(f"b{b}", b, 8, 30, 6, True) for b in (128, 256, 512, 1024)]),
    ("backward", [("par", 256, 8, 30, 6, True),
                  ("seq", 256, 8, 30, 6, False)]),
    ("iters", [(f"o1_i{i}", 256, 1, i, 6, True) for i in (1, 2, 4, 8)]
     + [(f"o{o}_i1", 256, o, 1, 6, True) for o in (2, 4)]),
    ("alphas", [(f"a{n}", 256, 8, 30, n, True) for n in (6, 4, 3, 2)]),
])
def test_sweep_points_are_the_jax_scripts(sweep, want):
    got = [(tag, c.batch, c.alm_cfg.max_iter, c.solver_cfg.max_iter,
            len(c.solver_cfg.alphas), c.solver_cfg.parallel_backward)
           for tag, c in pc2.points(args(sweep=sweep))]
    assert got == want
    for _, c in pc2.points(args(sweep=sweep, seq=True)):
        assert not c.solver_cfg.parallel_backward or sweep == "backward"
        assert c.batch1_steps is None and c.n_warmup == pc2.N_WARM
