"""Launch surfaces of the port: the serving tier."""
