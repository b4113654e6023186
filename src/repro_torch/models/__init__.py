"""Models operated as flat parameter vectors."""
