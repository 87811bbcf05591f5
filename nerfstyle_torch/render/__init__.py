"""Novel-view rendering of the port."""
