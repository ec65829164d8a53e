"""Acoustic-model training: host data path, optimizer and trainer."""
