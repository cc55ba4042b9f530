"""How a cell drives the program: one module an entry kind."""
