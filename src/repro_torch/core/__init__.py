"""Sketch system core: hashing, fragments, fleet engine, control, queries."""
