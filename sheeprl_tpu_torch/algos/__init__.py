"""Algorithm families of the port."""
