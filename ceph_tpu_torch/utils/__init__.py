"""Runtime helpers: the BlueStore Checksummer, and the port's copies of
dout logging, perf counters, the Throttle, the config schema and the
observability modules (tracer, critpath, flight, copytrack)."""
