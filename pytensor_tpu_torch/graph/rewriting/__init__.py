"""The rewrite engine and its tag-based database."""
