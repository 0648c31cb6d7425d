"""Drivers: how a cell drives the program, one module each, found by the
traffic file's ``driver`` (``chunk``, ``live``, ``multistream``).

A driver module defines ``Driver(cell, seed, device)``, which the harness
calls in this order:

* ``make_inputs() -> [(part, time)]``: the cell's inputs from the seed
  (frames, data); the memory peak is taken from after it;
* ``build() -> [(part, time)]``: the program, its weights, and the hooks
  that read the timed path;
* ``warmup()``: every shape the window uses, counted as set-up;
* ``window(seconds, record) -> dict``: the measured window, with
  ``frames``, ``wall_s`` and ``marks`` (seconds since the window opened
  and frames done, after each step), and ``latencies_ms`` where the
  driver takes them (``record``: the runs that read per-layer metrics);
* ``traced() -> frames``: the steps run under the profiler;
* ``finish() -> dict``: ``attempted``, ``failed`` and ``diag``, once the
  window's work is on the host;
* ``fill(run)``: the program's readings for the per-layer readers
  (:class:`benchmark.harness.RunInfo`);
* ``close()``: frees the program's state;
* ``outputs()``: what the check's numbers (``compare/<number>.py``)
  read, also before ``build`` (the controls).
"""
