"""The plain reference the benchmark holds the program to (numpy and plain
torch; nothing of the program)."""
