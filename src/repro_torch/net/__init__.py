"""Network substrate: topology, synthetic traffic, replay."""
