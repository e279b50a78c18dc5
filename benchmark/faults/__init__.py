"""Faults to read: each module's ``plant()`` breaks one piece of the port
underneath the timed path, for ``python3 -m benchmark.calibrate --fault
<name>`` and the CPU tests.  No benchmark run plants one."""
