"""Serving: the micro-batched HTTP server for translation and sampling."""
