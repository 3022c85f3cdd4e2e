"""Scene generators, one module per configuration (`<config name>.py`, with
`build(config) -> dict`). Each is a frozen numpy copy of the program's own
generator, so the program and the plain reference get the same arrays."""
