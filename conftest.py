"""Settings for the whole CPU test run.

pytest loads this file before ``tests/conftest.py``, and so before jax or
torch is imported. It sizes each xdist worker's thread pools, marks the
reference tests that hang as ``slow`` and gives every test a time limit.
"""

import faulthandler
import os
import signal

import pytest

# Each xdist worker gets its share of the cores. With torch's pool sized for
# the whole machine in each of 6 workers on 8 cores, test_torch_ais.py's AIS
# test took 347 s of a whole run, and 5.5 s at one thread; XLA:CPU's
# multi-threaded Eigen made two interpret-mode DP tests 1.2-2.3x slower even
# alone. torch sizes its pool from OMP_NUM_THREADS when it is imported, and
# the variables reach the rank processes that tests spawn. A worker assigns
# them, since it inherits its controller's environment; elsewhere they stay
# as the user set them.
if "PYTEST_XDIST_WORKER" in os.environ:
    _share = max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_name] = str(_share)
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_cpu_multi_thread_eigen" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_cpu_multi_thread_eigen=false").strip()

# The W-blocked DP tests deadlock the reference's Pallas interpret mode at 8
# simulated devices on an 8-core host (jax 0.9.0: every device thread parked
# in the interpreter's callbacks, even alone); -m 'not slow' leaves them out.
SLOW = frozenset(f"tests/test_pallas_dp_wb.py::{name}" for name in (
    "test_dp_wblocked_exact_parity",
    "test_dp_wblocked_uneven_batch20_exact",
    "test_dp_wblocked_gaussian_exact",
    "test_dp_wblocked_wide_offset_exact_parity",
    "test_dp_wblocked_wide_offset_uneven_exact",
))

# Seconds any one test may run: about three times the slowest test of a whole
# run (72-104 s, CHANGES.md), and longer than the rank helpers' own 120 s
# deadlines. A test blocked in native code is not ended by it: no Python
# handler runs there, and only the stack dump 30 s later shows where it is.
TEST_LIMIT_S = 300

_real_stderr = pytest.StashKey[int]()


def pytest_configure(config):
    # output capture is off here, so this is the terminal's stderr
    config.stash[_real_stderr] = os.dup(2)


@pytest.hookimpl(tryfirst=True)  # before -m deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid.partition("[")[0] in SLOW:
            item.add_marker(pytest.mark.slow)


def _over_limit(signum, frame):
    raise TimeoutError(f"test ran past TEST_LIMIT_S = {TEST_LIMIT_S} s (conftest.py)")


@pytest.fixture(autouse=True)
def _test_time_limit(request):
    """Fails a test past TEST_LIMIT_S with a TimeoutError, so that the worker
    goes on to the next test. A test stuck in native code, where no handler
    runs, has every thread's stack dumped 30 s later; a dump while the
    TimeoutError unwinds the main thread's frames crashed workers."""
    previous = signal.signal(signal.SIGALRM, _over_limit)
    signal.alarm(TEST_LIMIT_S)
    faulthandler.dump_traceback_later(TEST_LIMIT_S + 30, exit=False,
                                      file=request.config.stash[_real_stderr])
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)
