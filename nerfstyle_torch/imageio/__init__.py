"""Image codecs in numpy and the standard library: the port reads and
writes the images the JAX package handles through PIL, without PIL.

``png``: 8-bit PNG (gray, gray + alpha, RGB, RGBA; plain or Adam7
interlaced).  ``jpeg``: sequential and progressive Huffman JPEG (gray, colour,
CMYK), decoded as libjpeg does under PIL's defaults.  ``gif``: an animated GIF89a writer.
"""
