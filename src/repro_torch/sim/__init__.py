"""The IoV simulator of the port (serial engine, ``ours`` family)."""
