"""Dataset plugins of the port (constants and head metas only)."""
