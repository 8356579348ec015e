"""Runtime helpers: the BlueStore Checksummer, and the port's copies of
dout logging, perf counters, the Throttle family, the config schema, the
observability modules (tracer, critpath, flight, copytrack), the safety
hooks (sanitizer, loophook, crash) and the daemon runtime (async_util,
reactor's thread shards, loopprof, admin_socket, buffer)."""
