"""Runtime helpers: the BlueStore Checksummer, and the port's copies of
dout logging, perf counters and the Throttle."""
