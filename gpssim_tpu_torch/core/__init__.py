"""Host-side GPS core: time systems, geodesy, orbits, nav message, channels."""
