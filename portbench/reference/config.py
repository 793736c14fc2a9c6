"""Decoder configuration (mirrors mbe_tpu.utils.config)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static configuration for pipeline.step / run_sequence.

    Attributes:
      codec: one of pipeline.CODECS.
      tones_enabled: False mirrors DISABLE_AMBE_TONES (mbelib.c:747-751):
        AMBE tone frames render silence with the tone state kept. IMBE has
        no tones.
      int16_output: convert PCM to int16 (the `short` API).
      validate_lanes: per-lane MBE_STATUS_INVALID_BITS masking inside the
        step (invalid lanes -> silence + state rollback + status=-2).
    """

    codec: str = "imbe7200"
    tones_enabled: bool = True
    int16_output: bool = False
    validate_lanes: bool = True


DEFAULT = DecoderConfig()
