"""Host reading of strawboat files: footer, schema and page preludes."""
