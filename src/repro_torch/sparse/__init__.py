"""Block-sparse attention masks: block scores + mass-threshold selection."""
