"""One driver an entry point of the program, found by a workload's
``entry`` name. A driver's ``Entry`` builds the program's objects and the
inputs in set-up, makes one call (``call``), reads what a call did
(``after``), frees the program (``release``) and judges the outputs
against the reference (``check``). With ``program="control"`` the plain
reference, in the precision below the configuration's, takes the
program's place."""
