"""The benchmark's plain reference: the same semantics as the statements
under test, in plain PyTorch, in float64 where it sums.  It imports
nothing of the program."""
