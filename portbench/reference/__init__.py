"""The plain reference the benchmark checks the port against.  It imports
nothing of the program under test."""
