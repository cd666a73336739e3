"""Shared by the per-phase rehearsal files of ``chip_smoke.py``
(``tests/test_torch_chip_smoke_phase*.py``) and the port's other test
files of many small tensor ops (the protocol explorer and fuzz): the
repository root on ``sys.path`` (so ``import chip_smoke`` works) and an
autouse fixture, imported into a test module, that runs its tests on
one intra-op thread.

Those tests run many small tensor ops. With pytest-xdist's other
workers busy on every core, torch's pool of one thread a core spent most
of its time waiting for its own threads: the phase 22 rehearsal took
~100x its serial 3 s beside other busy processes, and 2.4 s on one
thread beside the same load.
"""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run the module's tests (and its module fixtures) on one intra-op
    thread, then restore the pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
