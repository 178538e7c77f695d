from .beam_search_decoder import BeamSearchDecoder

__all__ = ["BeamSearchDecoder"]
