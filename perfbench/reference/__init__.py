"""The benchmark's plain reference: no kernel and nothing of the port."""
