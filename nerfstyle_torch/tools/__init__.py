"""Entry points of the port beside the CLIs: runs that check quality (the
counterpart of the repository's ``tools/``)."""
