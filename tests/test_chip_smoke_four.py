"""chip_smoke.py --four's phase on 4 of conftest's 8 virtual CPU devices:
data-parallel training and both multi-device separation layouts, each
against one device with the same seeds. (Its own file so that pytest-xdist
runs it beside the single-device rehearsal.)"""

import dataclasses

import chip_smoke as cs


def test_four_devices_match_one(tmp_path):
    """The --four phase on 4 of the 8 virtual CPU devices."""
    run = cs.Runner(str(tmp_path))
    data = cs.phase_synthesise(run.work, dataclasses.asdict(cs.TINY))
    got = cs.phase_four(run, data["song"], data["stems"], cs.TINY, "cpu")
    assert got["train_rel"] <= cs.TOL_LAYOUT
    for layout in ("frames", "sources"):
        assert max(got[layout]) <= cs.TOL_LAYOUT
