"""Vehicle-side training and RSU-side aggregation of the port."""
