"""DynaWarp core: hashing, sketches, segments and the wave query engine."""
