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
"""

# Each file's seconds, its tests' setup, call and teardown summed, in one
# run of the whole suite with 6 workers on an 8-core host (1,434.7 s wall,
# 6,242.6 s of test time, 5,367.2 s of it in these files, every file above
# 150 s).
SLOW_FILES = (
    "test_pcsaft_mix.py",  # 699.6
    "test_tsolve.py",  # 650.5
    "test_fuzz_oracle.py",  # 540.2
    "test_flash_grad.py",  # 469.0, one test: the child process
    "test_cpu_backend.py",  # 380.1
    "test_gc_pcsaft.py",  # 379.1
    "test_critical.py",  # 368.8
    "test_diagrams.py",  # 324.2
    "test_warmstart.py",  # 282.0
    "test_oracle_grads.py",  # 259.5
    "test_pcsaft_pure.py",  # 248.4
    "test_consistency.py",  # 234.1
    "test_flash.py",  # 220.1
    "test_properties.py",  # 156.7
    "test_sharding.py",  # 154.9
)


def rank_of(nodeid):
    """Sort key of a test: its file's place in ``SLOW_FILES``, or one past
    the end for every other file.  A stable sort by it keeps each file's
    tests together and in order, and the other files in collection order."""
    name = nodeid.split("::", 1)[0].rsplit("/", 1)[-1]
    return SLOW_FILES.index(name) if name in SLOW_FILES else len(SLOW_FILES)
