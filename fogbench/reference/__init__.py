"""The plain reference that decides ``correct``: ``fog.tick`` advances a
state of its own (``fog.init_state``) by the benchmark's draws.  It imports
nothing of the program."""
