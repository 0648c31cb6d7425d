"""Plain references the check compares the program with; they import
nothing of the port."""
