"""Plain float32 references of the benchmark's configurations: torch
only, nothing of the program under test."""
