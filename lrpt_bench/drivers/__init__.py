"""One driver a traffic kind: it sets up the program, runs the measured
window and hands back what the metrics and the correctness check read.

A traffic mix's "kind" names its module here. run.py and the tests look up
what they need of a kind in its module, so a new kind is a new module and
a mix of that kind. A module holds:

- SPAN: the harness span around each call into the program in the window;
  the per-layer readers take the traced calls from it.
- NUMBERS: the names of the numbers check() compares, each with its limit
  under the mix's "limits" (one number, or one a configuration by name).
- SMALL: what a test on the CPU puts over the mix (tests/small.py).
- CONTROL: the readings that set the limits on the card
  (tests/test_lrpt_control.py): {"window_s": the window's seconds,
  "seeds": (sound, reordered, TF32) seed counts}.
- setup(run), window(run, st), end_to_end(run, st, w), release(st) and
  check(run, st): as run.execute calls them.
"""
