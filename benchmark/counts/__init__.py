"""Operation and byte counts of the algorithms the cells run."""
