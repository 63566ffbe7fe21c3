"""Seeded data of the configurations, and their Parquet writer."""
