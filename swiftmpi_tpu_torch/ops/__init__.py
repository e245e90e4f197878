"""Device-side word2vec math of the port: clipped sigmoid and sampling."""
