"""The plain references the benchmark judges the program by: a file
each, read by the family files that name it (``families/``)."""
