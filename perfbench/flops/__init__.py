"""Operation and byte counts of the models, from their shapes."""
