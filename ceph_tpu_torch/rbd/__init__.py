"""RBD-lite: striped block images over the librados subset.

The thin vertical slice of the reference block layer (src/librbd/, image
= header object + striped data objects; striping v1 semantics of
doc/man/8/rbd.rst: object size 2^order, image bytes laid out
sequentially across numbered data objects).
"""
from ceph_tpu_torch.rbd.image import RBD, Image, ImageNotFound

__all__ = ["RBD", "Image", "ImageNotFound"]
