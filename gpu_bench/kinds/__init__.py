"""One module a kind of mix, ``kinds/<kind>.py``, found by the ``kind``
that a mix's data file ``traffic/<mix>.json`` names.

Each module defines ``CONTROLS``, the names of the controls it can put in
the program's place, and ``Kind(mix, A, info, seed, device, spans, *,
plan=None, control=None)``: the cell's inputs and the program's state,
built in set-up from the mix, the configuration's host CSR ``A`` (and
``info``, what a solver may know of it) and ``--seed``, with the set-up's
spans written to ``spans``.  ``plan`` hands in a plan already made (the
calibration's many seeds on one plan); ``control`` puts a control in the
program's place.  A ``Kind`` has

- ``warm_up()``: every shape its calls use; the seconds a call takes;
- ``window(seconds, keep, traced=False)``: the closed loop of its calls,
  a :class:`gpu_bench.harness.traffic.Window` with what it counted and
  timed (a traced run may time more);
- ``free()``: drops the program's state before the reference runs;
- ``readings(kept)``: each number the cell compares, for every kept
  output, worked out by the plain reference;
- ``check(window, limits)``: the largest of each number, and how many
  outputs failed.
"""
