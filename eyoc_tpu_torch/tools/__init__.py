"""Tools of the port: the checkpoint importer and the similarity-table
recorder."""
