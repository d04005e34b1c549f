"""One driver for each kind of entry the benchmark's windows drive; a
traffic file names its driver by module name (``"engine"``)."""
