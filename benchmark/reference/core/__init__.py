"""Host-side GPS core, frozen from the port (time, geodesy, orbits, nav message, channels)."""
