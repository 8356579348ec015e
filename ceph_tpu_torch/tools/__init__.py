"""CLIs: the erasure-code benchmark."""
