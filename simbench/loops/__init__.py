"""Loops: the code of each path a traffic file can name
(``"loop": "<module>"``). A loop module defines ``Cell(config,
traffic, seed, device)``, whose constructor is the set-up (build the
program from the seed, warm every shape the window uses), and on it
``window(seconds, trace) -> (end-to-end values, traced record or None,
attempted)``, ``free()`` (drop the program before the check),
``layer_inputs(record)`` (the record the per-layer readers take) and
``check(control=False) -> {number: value}`` against the plain reference,
or with ``control`` the control in the program's place."""
