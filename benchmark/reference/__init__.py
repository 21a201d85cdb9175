"""Plain references of the configurations (one module per arch); they import
nothing of the program."""
