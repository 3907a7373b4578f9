"""Tools of the port that drive its CLIs end to end."""
