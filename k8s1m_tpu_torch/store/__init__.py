"""The in-process store the coordinator watches and binds into."""
