"""The program's side of a run, one file a model, found by a
configuration's ``model`` key.  Each module has

* ``Program(cell, seed, device, part)``: set-up (``part(name)`` times a
  part of it), the program built and handed the benchmark's inputs;
* ``Program.checked_steps()``: the program's first steps, through the
  window's own call and feed, whatever the window compiles or captures
  with them, and the state they leave;
* ``Program.profile()`` (traced runs, before the window): a call under
  ``torch.profiler``, returning the profile;
* ``Program.window(seconds)``: the measured call; returns ``{"attempted":
  steps, "values": {end-to-end metric: value}, "ctx": {...}}``;
* ``Program.count(ctx)`` (traced runs, after the window): the program's
  counters over a call, into the readers' context;
* ``Program.release()``: the program and its feed freed;
* ``Program.numbers()``: the compared numbers, the reference run;
* ``Program.trace_context(prof)``: the profiled window's context;
* ``readings(cell, seed, variants, device)``: the calibration readings
  (``benchmark/calibrate.py``) and ``VARIANTS``."""
