"""How the harness drives each trainer family of the program."""
