"""Small utilities of the port."""
