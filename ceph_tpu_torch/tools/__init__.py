"""CLIs: the erasure-code benchmark, the bench driver's stages, ec_tool,
the corpus non-regression check and the bitmatrix table generator."""
