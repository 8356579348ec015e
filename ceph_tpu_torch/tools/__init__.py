"""CLIs: the erasure-code benchmark, ec_tool, the corpus non-regression
check and the bitmatrix table generator."""
