"""The harness's own machinery: loading cells by name, the program adapter,
the clock and trace arithmetic, the comparison with the reference."""
