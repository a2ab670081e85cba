"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have: a step that returns its state
unchanged, half of a plane's words left out of the chain, an answer
altered where it is produced.  The run's look for a card is the one part
skipped (the plain versions run on the CPU).  Also the controls: the
reference put in the program's place in lower precision, or answering
stale snapshots, fails the limits."""
import numpy as np
import pytest

from hgbench import control, harness
from hgbench.tests import small

POINT = "growing.point-analytics"


def _run(name=POINT):
    return harness.run(small.cell(name), seed=small.SEED, seconds=0.2,
                       traced=False, device="cpu")


@pytest.mark.parametrize("name", small.CELLS)
def test_sound_runs_are_correct(name):
    assert _run(name).correct


def test_fused_step_returns_state_unchanged(monkeypatch):
    from repro_torch.runtime import torch_exec
    orig = torch_exec.delta_apply_fused_pair

    def unchanged(bn, an, dn, be, ae, de, *a, **k):
        return orig(bn, an[:0], dn[:0], be, ae[:0], de[:0], *a, **k)

    monkeypatch.setattr(torch_exec, "delta_apply_fused_pair", unchanged)
    assert not _run().correct


def test_half_of_batch_left_out(monkeypatch):
    """The chain applied to the first half of each plane's words only: the
    rest of the snapshot left at the base."""
    from repro_torch.runtime import torch_exec
    orig = torch_exec.delta_apply_fused_pair
    widths = []

    def half(bn, an, dn, be, ae, de, *a, **k):
        planes = []
        for adds, dels in ((an, dn), (ae, de)):
            adds, dels = adds.clone(), dels.clone()
            keep = adds.shape[1] // 2
            adds[:, keep:] = 0
            dels[:, keep:] = 0
            planes.append((adds, dels))
            widths.append(adds.shape[1])
        (an, dn), (ae, de) = planes
        return orig(bn, an, dn, be, ae, de, *a, **k)

    monkeypatch.setattr(torch_exec, "delta_apply_fused_pair", half)
    assert not _run().correct
    assert min(widths) > 1


def test_point_answer_altered(monkeypatch):
    from repro_torch.runtime import torch_exec
    orig = torch_exec.execute_singlepoint_fused

    def altered(*a, **k):
        nm, em, an = orig(*a, **k)
        em = em.copy()
        em[np.argmax(em)] ^= True          # one live edge dropped
        return nm, em, an

    monkeypatch.setattr(torch_exec, "execute_singlepoint_fused", altered)
    assert not _run(POINT).correct


def test_point_degrees_altered(monkeypatch):
    from repro_torch.runtime import torch_exec
    orig = torch_exec.SnapshotAnalytics.degrees

    def altered(self):
        d = orig(self)
        d[0] += 1
        return d

    monkeypatch.setattr(torch_exec.SnapshotAnalytics, "degrees", altered)
    assert not _run(POINT).correct


@pytest.mark.parametrize("name", small.CELLS)
def test_controls_fail_the_limits(name):
    out = control.readings(small.cell(name), small.SEED, 0.2, "cpu")
    assert out["correct"]
    assert out["controls"]
    for reading in out["controls"].values():
        assert any(v > out["limits"][n] for n, v in reading.items())
    gap = out["controls"]["bf16"]["weighted_total_rel_gap"]
    assert gap > out["limits"]["weighted_total_rel_gap"]
