"""Device operations of the port."""
