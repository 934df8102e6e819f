"""Plain float32 references of the port's models, for the tier-1 tests."""
