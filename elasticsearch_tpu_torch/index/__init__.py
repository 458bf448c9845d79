"""Index layer of the port: mappings, analysis and segments."""
