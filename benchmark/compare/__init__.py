"""The numbers the output check compares, one file per number named in a
cell's ``checks/<cell>.json``, each with ``value(out) -> float`` on what
the timed path produced and ``control(out, frames) -> float``, the same
number as the cell's control gives it; ``out`` is the driver's
``outputs()``."""
