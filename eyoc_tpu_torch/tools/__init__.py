"""Host tools of the port (the checkpoint importer)."""
