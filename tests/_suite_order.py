"""Longest-first order of the suite's test files.

Under ``pytest -n 6 --dist loadfile`` each file goes whole to one worker,
in the order of the work queue.  pytest-xdist's default queue puts the
files with the most tests first, which here are the port's fast files, and
hands out the JAX package's slow files, with few tests each, last: the
longest units then start when most of the run is over, and the run ends
with one worker busy long after the others.  The ``conftest.py`` at the
root of the repo turns that reordering off and sorts the collection by
``rank_of``, which puts the files of ``SLOW_FILES`` at its head, so the
queue is longest first.  A new test file that takes more than 150 s goes
into the tuple at its place by time.

The tests of ``SLOW_TESTS`` the same hook marks ``slow``, so that the
tier-1 run (``-m 'not slow'``) leaves them out.  A test of the JAX
reference goes there only when its time would crowd the run's clock and a
named port test holds the port to the same checks against JAX's values.
"""

# Each test's seconds in a whole run, and the port test that covers it.
SLOW_TESTS = (
    # 469.0 s before the long files were queued first, 612.4-725.5 s since,
    # in a child process; tests/test_torch_flash_grad.py runs the same
    # checks of tests/_flash_grad_checks.py on the port and holds it to
    # JAX's vendored Jacobians
    "tests/test_flash_grad.py::test_flash_gradients_in_child_process",
    # 545.4 s; tests/test_torch_mix_vle.py::test_bubble_point_all_gradients_fd
    # is the same check on the port, and
    # tests/test_torch_mix_jax_grad.py::test_pressure_gradients_match_jax_identity
    # holds its gradients to JAX's vendored ones
    "tests/test_pcsaft_mix.py::test_bubble_point_all_gradients_fd",
    # 293.3-325.5 s; tests/test_torch_critical.py::test_gradients_central_fd
    # is the same check on the port, and
    # tests/test_torch_critical.py::test_gradients_match_jax holds its
    # gradients to JAX's vendored ones
    "tests/test_critical.py::test_critical_point_gradients_fd",
)

# Each file's seconds, its tests' setup, call and teardown summed, in one
# run of the whole suite with 6 workers on an 8-core host (1,358.5 s wall,
# 7,803.5 s of test time, every file above 150 s).
SLOW_FILES = (
    "test_tsolve.py",  # 983.1
    "test_fuzz_oracle.py",  # 864.8
    "test_cpu_backend.py",  # 639.8
    "test_gc_pcsaft.py",  # 614.1
    "test_warmstart.py",  # 526.6
    "test_diagrams.py",  # 510.6
    "test_pcsaft_mix.py",  # 414.6
    "test_pcsaft_pure.py",  # 385.0
    "test_oracle_grads.py",  # 344.4
    "test_consistency.py",  # 340.6
    "test_flash.py",  # 325.9
    "test_properties.py",  # 241.8
    "test_sharding.py",  # 212.3
    "test_critical.py",  # 180.6
    "test_compat.py",  # 168.0
    "test_multicomponent.py",  # 167.7
)


def rank_of(nodeid):
    """Sort key of a test: its file's place in ``SLOW_FILES``, or one past
    the end for every other file.  A stable sort by it keeps each file's
    tests together and in order, and the other files in collection order."""
    name = nodeid.split("::", 1)[0].rsplit("/", 1)[-1]
    return SLOW_FILES.index(name) if name in SLOW_FILES else len(SLOW_FILES)
