"""Sinks (IQ file, null, hardware stubs), host FIFO transport, fetchers."""
