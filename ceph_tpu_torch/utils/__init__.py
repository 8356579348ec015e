"""Runtime helpers: the BlueStore Checksummer."""
