"""Plain references the correctness checks hold the port against."""
