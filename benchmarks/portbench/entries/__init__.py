"""The entries a cell's window drives, one module each, named by the
workload file's "entry": each has run(run) -> Outcome, and calibrate(run)
-> the readings of the program, the control and the faults for the limits
of its checks."""
