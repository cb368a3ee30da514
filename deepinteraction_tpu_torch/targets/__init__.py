"""Box coding of the port."""
