"""HTTP API: handlers and the evaluation service."""
