"""Core types and camera rays of the port."""
