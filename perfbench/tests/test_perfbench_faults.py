"""The harness's check, driven on the CPU at a small size past its look for a
card, with the timed path sound, broken underneath, and at the control
precision: `correct` comes out true only for the sound path. The faults are
those each cell can have: a tick that returns its state unchanged, half of
the batch left out, an answer altered where it is produced (the ticks have
no exchange between cards on their path); the control is the reference in
the program's place at the configuration's lower precision (the ticks) and
the answers as float32 would give them (the batch). And the command, without
a card, exits non-zero and prints no result.

    python -m pytest -p no:cacheprovider perfbench/tests
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"config": {"grid_size": 10},
         "traffic": {"batch": 4, "pool_ticks": 4, "pool_calls": 2, "sample_rows": 4, "sample_ticks": 2,
                     "sample_instances": 8}}
TICKS = ("di_tick_b512",)


def _run(cell, control=False):
    return harness.run_cell(cell, 2**31 + 5, 1.0, False, time.time(), control=control, device="cpu",
                            sizes=SIZES, log=lambda m: None)


@contextlib.contextmanager
def _patched(cls, name, make):
    own = getattr(cls, name)
    setattr(cls, name, make(own))
    try:
        yield
    finally:
        setattr(cls, name, own)


def _tick_fault(kind):
    def make(call):
        def broken(self, states, x0):
            new, u0, kkt, viol = call(self, states, x0)
            if kind == "unchanged":
                return states, u0, kkt, viol
            if kind == "half":
                h = x0.shape[0] // 2
                keep = lambda a, b: torch.cat([a[:h], b[h:]])
                return type(new)(*(keep(a, b) for a, b in zip(new, states))), keep(u0, u0 * 0), kkt, viol
            return new, u0 + 1e-3, kkt, viol  # altered
        return broken
    return make


def _batch_fault(kind):
    def make(call):
        def broken(self, z0, cl=None, cu=None, zl=None, zu=None):
            res = call(self, z0, cl, cu, zl, zu)
            if kind == "unchanged":
                return res._replace(z=z0.clone())
            if kind == "half":  # the second half left at its start, its status as solved
                h = z0.shape[0] // 2
                return res._replace(z=torch.cat([res.z[:h], z0[h:]]))
            if kind == "non-finite":  # one instance's answer lost, its status kept
                return res._replace(z=res.z.index_fill(0, torch.tensor([0]), float("nan")))
            return res._replace(z=res.z + 1e-3)  # altered
        return broken
    return make


@pytest.mark.parametrize("cell", TICKS)
def test_tick_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["failed"] == 0


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("cell", TICKS)
def test_tick_fault_is_caught(cell, fault):
    from ctdirect_tpu_torch.parallel.mpc import MPCController

    with _patched(MPCController, "__call__", _tick_fault(fault)):
        line = _run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", TICKS)
def test_tick_control_is_caught(cell):
    assert not _run(cell, control=True)["correct"]


def test_batch_sound_run_is_correct():
    line = _run("cartpole_batch_b1024")
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["failed"] == 0 < line["attempted"]


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered", "non-finite"))
def test_batch_fault_is_caught(fault):
    from ctdirect_tpu_torch.parallel.batch import BatchSolver

    with _patched(BatchSolver, "__call__", _batch_fault(fault)):
        line = _run("cartpole_batch_b1024")
    assert not line["correct"], line["checks"]


def test_batch_control_is_caught():
    assert not _run("cartpole_batch_b1024", control=True)["correct"]


def test_command_without_a_card_exits_non_zero():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "di_tick_b512", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_card):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "di_tick_b512", "--seed", "11",
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark never runs on the CPU)")
