"""The plain reference that decides ``correct``: NumPy and PyTorch only,
importing nothing of the program (``gpssim_tpu_torch``), of the JAX
package or of the native engine's loader. ``core/`` is a frozen copy of
the port's host-side GPS core (time, ephemerides, orbits, ranging, nav
message, channels); ``planner`` works the block plans out again from the
generated inputs; ``seqwalk`` replays the reference C's sequential
float64 phase recurrences; ``synth`` makes each block's bytes; ``check``
compares them with what the program wrote.
"""
