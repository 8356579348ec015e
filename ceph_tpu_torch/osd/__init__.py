"""OSD data plane: ECUtil stripe layout and codec (ec_util.py)."""
