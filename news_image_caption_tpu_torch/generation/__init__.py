"""Decode loops of the port: greedy, top-k sampling and beam search
(`generator`), exact speculative greedy (`speculative`) and the
continuous slot pool (`continuous`)."""
