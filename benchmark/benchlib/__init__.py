"""The benchmark's own library: cells found by name, the traffic generator,
the device trace's reduction, the kernels' work counts and the checks."""
