"""Encode-session API of the port (mirrors Source/API/EbSvtAv1Enc.h:
init_handle/set_parameter/init/send_picture/get_packet/...).

A copy of `svt_av1_psy_tpu/api.py`. Every `from .<module>` import of a
reference module reads `from svt_av1_psy_tpu.<module>`; the twins
`codec.intra_rdo`, `codec.inter_encoder`, `codec.temporal_filter` and
`parallel.pipeline` stay relative and resolve to this package. The other
changes, by line of the reference:

- :69 `Encoder(config, device="cuda")` resolves the torch device
  (`device.resolve`: no card raises; nothing falls back to the CPU).
- :101 `init` refuses every option whose device program is not ported yet:
  only `tpu_mesh_shape` now (:219-227 are gone). `commit_backend="device"`
  runs the port's K5 + K6 commit on the encoder's device; its "auto" stays
  off, as in the reference.
- :241-273 the inter-search pipeline runs on the encoder's device;
  `device_backend_default` asks whether that device is CUDA, and a failure
  to start raises instead of warning and running native.
- :276 the log line names the package and the device.
- :431, :557 `temporal_filter` gets the encoder's device.
- :448, :715 `tpl_analysis` is the port's twin (`rc.tpl`: K2 + K7) and gets
  the encoder's device; its "auto" runs the device pass when that device is
  CUDA. `tpl_qindex` and `tpl_sb_qindex_map` stay the reference's.
- :1424 `cdef_frame` is the port's twin (`codec.cdef`: K8) and :1467
  `pick_lr` the port's twin (`codec.restoration`: K9, no host fallback);
  both get the encoder's device and run their device branch with
  `filters_backend="device"`. The restoration search runs under a
  `host:lr_search` stage (the reference leaves it unbracketed), and the
  twins time their device parts as `device:cdef` and `device:lr_search`.
- :644-647 a failed submit raises instead of returning None.
- :1157 `search_intra_decisions` gets the encoder's device.
- :1167 `inter_shared["torch_device"]` carries the device to the inter
  encoder (its closed-loop device decide).
- :1192-1201 `get()` never returns None (it raises), so the rows are used
  without the None checks.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from svt_av1_psy_tpu.bitstream.obu import (
    FrameParams,
    SequenceParams,
    frame_obu,
    sequence_header_obu,
    temporal_delimiter_obu,
)
from svt_av1_psy_tpu.codec.intra_encoder import IntraFrameEncoder
from svt_av1_psy_tpu.config import (EncoderConfig, PredStructure, RateControlMode,
                     verify_settings)
from svt_av1_psy_tpu.errors import ErrorCode, SvtAv1Error


@dataclass
class Packet:
    data: bytes
    pts: int
    frame_type: str = "key"
    recon: Optional[tuple] = None
    stats: Optional[dict] = None


def _chroma_qindex_delta(base_q: int, tune: int, color_primaries: int,
                         ext_crf_offset: int = 0) -> int:
    """Tune-specific chroma qindex offset (rc_process.c:3436-3473): tunes
    2/3/4 boost chroma with qindex-dependent ramps; BT.2020 primaries get an
    extra boost; the extended-CRF quarter-step remainder is added to chroma
    unconditionally (rc_process.c:3466). Returned delta is the coded u/v
    dc+ac delta q."""
    adj = base_q
    chroma_q = base_q + ext_crf_offset
    if tune == 2:
        a2 = max(0, adj - 48)
        chroma_q -= int(np.clip(round(a2 ** 1.4 / 9.0), 0, 16))
    elif tune == 3:
        chroma_q += -round(adj / 8.0)
    elif tune == 4:
        chroma_q -= int(np.clip(adj // 2 - 14, 0, 16))
    if color_primaries == 9:  # BT.2020
        chroma_q -= int(np.clip(adj // 2 - 8, 0, 16))
    return int(np.clip(chroma_q - base_q, -64, 63))


# options whose device program the port has not ported yet -> ROADMAP item
_UNPORTED = (
    ("tpu_mesh_shape", lambda c: bool(c.tpu_mesh_shape),
     "the multi-device mesh (ROADMAP queue 1, item 10)"),
)


def _refuse_unported(cfg):
    for name, hit, item in _UNPORTED:
        if hit(cfg):
            raise SvtAv1Error(
                ErrorCode.ERROR_BAD_PARAMETER,
                f"{name}={getattr(cfg, name)!r} needs {item}, which "
                "svt_av1_psy_tpu_torch does not have yet")


def _crf_to_qindex(crf: float) -> int:
    """CRF (0..70, quarter steps) -> base qindex. The reference maps CRF to
    qindex*4 with extended-CRF offsets (rc_process.c:3421); v0 uses the
    linear core mapping."""
    return int(np.clip(round(crf * 4), 0, 255))


class Encoder:
    def __init__(self, config: EncoderConfig, device="cuda"):
        from .device import resolve

        self.device = resolve(device)
        self.config = verify_settings(config)
        self._initialized = False
        self._packets: deque = deque()
        self._frame_count = 0
        self._seq: Optional[SequenceParams] = None
        self._recon_last = None
        self._ref_planes = None
        self._golden_planes = None
        # hierarchical (RANDOM_ACCESS) scheduling state
        self._gop_buf: list = []
        self._last_slot = 0
        self._sub_since_key = 0
        self._prev_sub_y = None
        self._rc = None
        self._tpl = None
        self._ipp_hist = []    # [(dpb_slot, planes)] of recent LAST frames
        self._prev_src_y = None
        self._frames_since_key = 0
        self._la_queue: deque = deque()   # TF lookahead (y, u, v, pts)
        self._tf_past: list = []          # last original sources for TF
        self._submitted = 0
        self._forced_keys: set = set()    # submit indices forced to key
        self._sub_idx = 0                 # display-order _submit counter
        # device (TPU) inter-search pipeline state
        self._use_device_me = False
        self._me_pipe = None
        self._pending_gops: list = []     # held GoPs (search in flight)
        self._queue_base_src = None       # open-loop base ref source
        self._gop_seq = 0

    # -------------------------------------------------------------- lifecycle
    def init(self):
        cfg = self.config
        _refuse_unported(cfg)
        from svt_av1_psy_tpu.codec.presets import preset_config

        self._pc = preset_config(cfg.preset)
        mono = cfg.color_format == 0
        self._seq = SequenceParams(
            cfg.width,
            cfg.height,
            still_picture=cfg.avif or int(cfg.tune) == 4,
            reduced_still_picture_header=cfg.avif,
            monochrome=mono,
            bit_depth=cfg.input_depth,
            color_primaries=cfg.color_primaries,
            transfer_characteristics=cfg.transfer_characteristics,
            matrix_coefficients=cfg.matrix_coefficients,
            color_range=cfg.color_range,
            chroma_sample_position=cfg.chroma_sample_position,
            # --fast-decode trims decoder-side filter cost: level 2 drops
            # CDEF too (enc_settings.c fast_decode -> shallower loop
            # filters / restoration gating)
            enable_cdef=cfg.cdef_level != 0 and cfg.fast_decode < 2,
            enable_filter_intra=True,
            # per-plane u/v delta_q diverge only via the user offsets
            # (quantization_params needs separate_uv_delta_q to code v)
            separate_uv_delta_q=(
                cfg.chroma_u_dc_qindex_offset != cfg.chroma_v_dc_qindex_offset
                or cfg.chroma_u_ac_qindex_offset
                != cfg.chroma_v_ac_qindex_offset),
            # explicit 1 forces LR on; -1 (auto) defers to the preset ladder
            enable_restoration=((cfg.enable_restoration_filtering > 0
                                 or (cfg.enable_restoration_filtering < 0
                                     and self._pc.restoration))
                                and cfg.fast_decode == 0
                                and cfg.tile_columns == 0 and cfg.tile_rows == 0),
            enable_superres=int(cfg.superres_mode) != 0,
            # inter-intra compound: the syntax is seq-gated only, so the bit
            # is on exactly when every inter frame takes the II-aware walk
            # (single tile, slower presets; matches the OBMC gate)
            enable_interintra_compound=(cfg.preset <= 6
                                        and cfg.tile_columns == 0
                                        and cfg.tile_rows == 0
                                        and not mono),
            # masked compound (wedge): same walk gate as inter-intra
            enable_masked_compound=(cfg.preset <= 6
                                    and cfg.tile_columns == 0
                                    and cfg.tile_rows == 0),
            # order hints: unlocks skip_mode (and, later, jnt-comp
            # distance weights / ref_frame_mvs); off for still pictures
            enable_order_hint=not (cfg.avif or int(cfg.tune) == 4),
            # temporal MV projection (MFMV): --enable-mfmv (-1 auto = on
            # whenever order hints are, matching enc_settings.c)
            enable_ref_frame_mvs=(not (cfg.avif or int(cfg.tune) == 4)
                                  and cfg.enable_mfmv != 0),
        )
        # DPB order-hint mirror (RefOrderHint[8]) + display-order counter
        self._dpb_hints = [0] * 8
        # DPB motion-field side data (spec 7.20 storage) per slot: the
        # saved 8x8 (ref, mv) field + frame metadata MFMV projects from
        self._dpb_mf = [None] * 8
        self._disp_idx = 0
        # film grain: explicit table takes precedence over the estimation
        # model driven by --film-grain (app_config.c:2869 precedence warning)
        self._film_grain = None
        self._fg_estimate_pending = False
        self._fg_noise_floor = None
        if cfg.fgs_table_path:
            from svt_av1_psy_tpu.codec.film_grain import parse_fgs_table

            entries = parse_fgs_table(Path(cfg.fgs_table_path).read_text())
            if entries:
                self._film_grain = entries[0][2]
                self._film_grain.bit_depth = cfg.input_depth
        elif cfg.film_grain_denoise_strength > 0:
            # estimation-based grain (noise_model.c path): fitted from the
            # first source frame in send_picture; the sequence header must
            # already declare grain support
            self._fg_estimate_pending = True
        self._seq.film_grain_params_present = (
            self._film_grain is not None
            or cfg.film_grain_denoise_strength > 0)
        # HDR metadata OBUs (MDCV/CLL), attached to key frames (the
        # reference's app-layer metadata array path, metadata_handle.c)
        from svt_av1_psy_tpu.codec.metadata import (METADATA_TYPE_HDR_CLL,
                                     METADATA_TYPE_HDR_MDCV,
                                     parse_content_light,
                                     parse_mastering_display)

        self._metadata_obus = b""
        self._frame_t35 = {}      # pts -> [T35 payloads] (add_metadata)
        mdcv = parse_mastering_display(cfg.mastering_display)
        if mdcv:
            from svt_av1_psy_tpu.bitstream.obu import metadata_obu

            self._metadata_obus += metadata_obu(METADATA_TYPE_HDR_MDCV, mdcv)
        cll = parse_content_light(cfg.content_light)
        if cll:
            from svt_av1_psy_tpu.bitstream.obu import metadata_obu

            self._metadata_obus += metadata_obu(METADATA_TYPE_HDR_CLL, cll)
        # two-pass: pass 1 collects stats only; pass >= 2 loads budgets
        self._firstpass = None
        self._budgets = None
        self._spent_bits = 0
        if cfg.pass_num == 1:
            from svt_av1_psy_tpu.rc.firstpass import FirstPassWriter

            self._firstpass = FirstPassWriter()
        elif cfg.pass_num >= 2 and (cfg.rc_stats_buffer or cfg.stats_file):
            from svt_av1_psy_tpu.rc.firstpass import parse_stats, second_pass_budgets

            # in-memory stats buffer (SvtAv1FixedBuf rc_stats_buffer,
            # EbSvtAv1Enc.h) takes precedence over the stats file path
            raw = (bytes(cfg.rc_stats_buffer) if cfg.rc_stats_buffer
                   else Path(cfg.stats_file).read_bytes())
            stats = parse_stats(raw)
            self._budgets = second_pass_budgets(
                stats, cfg.target_bit_rate, cfg.fps_num / max(cfg.fps_denom, 1))
        # --lp/--pin/--ss: one worker thread is the only host parallelism
        # on this architecture; lp 1 requests fully synchronous operation
        # (no search/commit overlap). pin/ss are NUMA placement hints with
        # no effect on a TPU host — acknowledged, not acted on.
        lp = cfg.level_of_parallelism or cfg.logical_processors
        if cfg.pin_threads or cfg.target_socket >= 0:
            from svt_av1_psy_tpu.log import svt_info as _svt_info

            _svt_info("pin/ss thread-placement hints have no effect on "
                      "this platform")
        # device (TPU) inter mode-decision search: prefetch whole mini-GoP
        # chunks through a worker thread, overlapped with the commit walk
        # (parallel/pipeline.py). "auto" = on when an accelerator exists.
        if (not cfg.avif and cfg.pred_structure == PredStructure.RANDOM_ACCESS
                and lp != 1):
            from .parallel.pipeline import (device_backend_default,
                                            get_pipeline)

            mode = str(cfg.inter_me_backend)
            # auto: the device search is at/above native-search quality at
            # the fast presets (-7.7% bytes +0.08dB at 480p p10) and on
            # SHORT pyramid intervals at every preset; on long intervals
            # (deep-GoP base layers) its open-loop source-ref costs lose
            # ~1.4dB to the closed-loop native kernel, so quality presets
            # run a hybrid: device rows for intervals <= 4, native decide
            # above (tools/ab_search.py A/B)
            # p<=8 hybrid: the device decides only unreferenced leaf
            # frames (interval 1, +/-0.03dB vs native); referenced frames
            # keep the closed-loop native decide, seeded by the device MVs
            self._dev_me_max_dist = (1 << 20 if (mode == "device"
                                                 or cfg.preset >= 9) else 1)
            if mode == "device" or (mode == "auto"
                                    and device_backend_default(self.device)):
                self._me_pipe = get_pipeline(
                    bd=cfg.input_depth, depths=self._pc.inter_depths,
                    rect=self._pc.inter_rect, device=self.device)
                # builds the kernels off the critical path
                self._me_pipe.warm(cfg.height, cfg.width)
                self._use_device_me = True
        from svt_av1_psy_tpu.log import svt_info

        svt_info("svt-av1-psy-tpu-torch: %dx%d preset %d %s on %s, "
                 "inter search %s", cfg.width, cfg.height, cfg.preset,
                 cfg.rate_control_mode.name, self.device,
                 "device" if self._use_device_me else "native")
        self._initialized = True
        return self

    # stream-info ids (EbSvtAv1Enc.h SVT_AV1_STREAM_INFO_*)
    STREAM_INFO_FIRST_PASS_STATS_OUT = 1

    def add_metadata(self, pts: int, t35_payload: bytes):
        """Attach an ITU-T T.35 metadata OBU (Dolby Vision RPU, HDR10+,
        closed captions) to the frame submitted with this pts — the
        svt_add_metadata / EB_AV1_METADATA_TYPE_ITUT_T35 path the
        reference app uses for --dolby-vision-rpu / HDR10+ JSON
        (metadata_handle.c:77, app_process_cmd.c)."""
        self._frame_t35.setdefault(int(pts), []).append(bytes(t35_payload))

    def get_stream_info(self, info_id: int = 0):
        """svt_av1_enc_get_stream_info analog (EbSvtAv1Enc.h:1153).
        id 1 returns the first-pass stats buffer (pass 1 sessions);
        id 0 (extension) returns a summary dict of the session so far."""
        self._check_init()
        if info_id == self.STREAM_INFO_FIRST_PASS_STATS_OUT:
            return (self._firstpass.serialize()
                    if self._firstpass is not None else None)
        return {
            "frames_encoded": self._frame_count,
            "bytes_written": self._spent_bits // 8,
            "last_qindex": getattr(self, "_last_qindex", None),
            "width": self.config.width,
            "height": self.config.height,
            "preset": self.config.preset,
        }

    def first_pass_data(self) -> bytes:
        """Serialized first-pass statistics (--pass 1 output)."""
        if self._firstpass is None:
            raise SvtAv1Error(ErrorCode.ERROR_BAD_PARAMETER, "not in pass 1")
        return self._firstpass.serialize()

    def stream_header(self) -> bytes:
        """svt_av1_enc_stream_header: the sequence header OBU."""
        self._check_init()
        return sequence_header_obu(self._seq)

    def send_picture(self, y: np.ndarray, u=None, v=None,
                     pts: Optional[int] = None, pic_type: int = 0):
        """Submit one picture. Synchronous (packet available immediately)
        unless temporal filtering with lookahead is active, in which case
        pictures buffer until their TF window fills — call flush() at EOS.

        pic_type: 1 requests a key frame at this picture; honored only
        when force_key_frames is enabled (the reference's pic_type on the
        buffer header gated by enable-force-key-frames,
        EbSvtAv1Enc.h force_key_frames)."""
        self._check_init()
        cfg = self.config
        if cfg.force_key_frames and pic_type == 1:
            self._forced_keys.add(self._submitted)
        if self._fg_estimate_pending:
            # fit the film-grain noise model to the first source frame
            # (noise_model.c svt_aom_denoise_and_model_run analog)
            self._fg_estimate_pending = False
            from svt_av1_psy_tpu.codec.noise_model import estimate_film_grain

            fg, _ = estimate_film_grain(
                np.asarray(y), None if u is None else np.asarray(u),
                None if v is None else np.asarray(v), bd=cfg.input_depth,
                # --adaptive-film-grain: grain-model footprint scales with
                # resolution (>=1080p grain correlates over a longer range)
                ar_lag=(3 if (cfg.adaptive_film_grain
                              and min(cfg.width, cfg.height) >= 1080)
                        else 2))
            if fg is None:
                from svt_av1_psy_tpu.codec.film_grain import photon_noise_params

                # clean content but grain requested: photon-noise profile
                fg = photon_noise_params(cfg.film_grain_denoise_strength,
                                         cfg.input_depth)
            self._film_grain = fg
        if (cfg.film_grain_denoise_apply
                and cfg.film_grain_denoise_strength > 0):
            # encode the denoised source (--film-grain-denoise 1)
            from svt_av1_psy_tpu.codec.noise_model import analyze_plane, dct_denoise, \
                noise_dct_floor

            if self._fg_noise_floor is None:
                got = analyze_plane(np.asarray(y))
                if got is not None:
                    blocks, flat, _, resid, _ = got
                    fi = np.flatnonzero(flat)
                    if len(fi) >= 4:
                        self._fg_noise_floor = noise_dct_floor(
                            resid[fi], cfg.input_depth)
            if self._fg_noise_floor is not None:
                y = dct_denoise(np.asarray(y), self._fg_noise_floor,
                                cfg.input_depth)
        if self._firstpass is not None:
            self._firstpass.push(np.asarray(y), cfg.input_depth)
            self._submitted += 1
            return
        la = cfg.look_ahead_distance
        if ((cfg.enable_tf or cfg.enable_tpl_la) and la is not None and la > 0
                and not cfg.avif):
            self._la_queue.append((np.asarray(y), u, v,
                                   pts if pts is not None else self._submitted))
            self._submitted += 1
            # quality presets hold a deeper lookahead so TPL propagates
            # over a longer dependency window (src_ops_process.c TPL
            # groups; the reference's windows reach the whole mini-GoP)
            la_cap = min(la, 7 if self.config.preset <= 6 else 3)
            while len(self._la_queue) > la_cap:
                self._tf_encode_head()
            return
        self._submitted += 1
        return self._submit(y, u, v, pts)

    def flush(self):
        """Drain the lookahead queue and any buffered mini-GoP (EOS)."""
        while self._la_queue:
            self._tf_encode_head()
        self._drain_gop()

    def _tf_encode_head(self):
        from .codec.temporal_filter import temporal_filter

        cfg = self.config
        y, u, v, pts = self._la_queue.popleft()
        # predicted frame type picks the PSY strength (kf vs inter TF)
        ip = cfg.intra_period_length
        will_key = (self._frame_count == 0 or self._ref_planes is None
                    or (ip >= 0 and self._frames_since_key > ip))
        # the reference filters KEY frames and base-layer ALTREFs only
        # (svt_av1_init_temporal_filtering is dispatched for those picture
        # types, me_process.c:322); leaf/mid frames pass through. ALTREF
        # TF happens at GoP assembly (_queue_gop) where the mini-GoP top
        # and its neighbors are all in hand.
        strength = cfg.kf_tf_strength if (cfg.enable_tf and will_key) else 0
        neighbors = list(self._tf_past) + [(f[0], f[1], f[2])
                                           for f in list(self._la_queue)[:3]]
        if (will_key and cfg.enable_tpl_la and self._pc.tpl and self._la_queue
                and cfg.rate_control_mode == RateControlMode.CRF_CQP):
            from .rc.tpl import tpl_analysis

            tpl_win = 7 if cfg.preset <= 6 else 3
            group = [y] + [f[0] for f in list(self._la_queue)[:tpl_win]]
            from svt_av1_psy_tpu.profiling import stage as _st

            with _st("host:tpl"):
                self._tpl = tpl_analysis(group, cfg.input_depth,
                                         backend=cfg.tpl_backend,
                                         device=self.device)
        from svt_av1_psy_tpu.profiling import stage as _stage

        with _stage("tf"):
            fy, fu, fv = temporal_filter((y, u, v), neighbors, strength,
                                         cfg.input_depth,
                                         backend=cfg.tf_backend,
                                         device=self.device)
        self._tf_past.append((y, u, v))
        if len(self._tf_past) > 2:
            self._tf_past.pop(0)
        self._submit(fy, fu, fv, pts)

    def _intra_mode_candidates(self):
        """Intra search candidate set. --enable-paeth / --enable-smooth 0
        remove those modes from the SEARCH (coding support is unaffected),
        matching the reference's intra level gating
        (enc_mode_config.c set_intra_ctrls paeth/smooth levels)."""
        from svt_av1_psy_tpu.codec.constants import PredictionMode as P

        modes = [P.DC_PRED, P.V_PRED, P.H_PRED, P.D45_PRED, P.D135_PRED,
                 P.D113_PRED, P.D157_PRED, P.D203_PRED, P.D67_PRED,
                 P.SMOOTH_PRED, P.SMOOTH_V_PRED, P.SMOOTH_H_PRED,
                 P.PAETH_PRED]
        cfg = self.config
        if cfg.enable_paeth == 0:
            modes.remove(P.PAETH_PRED)
        if cfg.enable_smooth == 0:
            for m in (P.SMOOTH_PRED, P.SMOOTH_V_PRED, P.SMOOTH_H_PRED):
                modes.remove(m)
        return tuple(modes)

    # -------------------------------------------- hierarchical scheduling
    def _submit(self, y, u, v, pts):
        """Display-order frame intake. LOW_DELAY: flat IPPP (synchronous).
        RANDOM_ACCESS: mini-GoP-4 two-level pyramid with unshown ALTREF +
        show_existing_frame (the reference's prediction structure,
        pred_struct_ctor / pic_decision re-planned as explicit DPB slot
        roles). Key decisions (keyint + scene cuts) happen here, in display
        order, before any reordering."""
        from svt_av1_psy_tpu.config import PredStructure

        cfg = self.config
        forced = self._sub_idx in self._forced_keys
        self._sub_idx += 1
        if cfg.pred_structure != PredStructure.RANDOM_ACCESS or cfg.avif:
            return self._encode_frame(
                y, u, v, pts, gop={"is_key": True} if forced else None)
        y = np.asarray(y)
        ip = cfg.intra_period_length
        is_key = forced or (self._ref_planes is None
                            or (ip >= 0 and self._sub_since_key > ip))
        if (not is_key and cfg.scene_change_detection and self._pc.scene_change
                and self._prev_sub_y is not None):
            from svt_av1_psy_tpu.codec.scene_change import detect_scene_change

            from svt_av1_psy_tpu.profiling import stage as _st

            with _st("host:analysis"):
                is_key = detect_scene_change(self._prev_sub_y, y,
                                             cfg.input_depth)
        self._prev_sub_y = y.copy()
        if is_key:
            self._drain_gop()
            self._encode_frame(y, u, v, pts, gop={"is_key": True})
            self._queue_base_src = y
            self._last_slot = 0
            self._sub_since_key = 1
            return
        self._sub_since_key += 1
        self._gop_buf.append((y, u, v, pts))
        gop_n = 1 << min(max(cfg.hierarchical_levels, 2), 5)
        if cfg.startup_mg_size and self._sub_since_key <= gop_n:
            # --startup-mg-size: the first mini-GoP after a key uses a
            # shallower pyramid so references establish quickly
            # (enc_settings.c startup_mg_size 2/3/4 levels)
            gop_n = min(gop_n, 1 << min(max(cfg.startup_mg_size, 2), 4))
        if len(self._gop_buf) == gop_n:
            buf, self._gop_buf = self._gop_buf, []
            for part in self._split_gop_dynamic(buf):
                self._queue_gop(part)

    def _split_gop_dynamic(self, buf):
        """Dynamic mini-GoP (--enable-dg; pd_process.c:724
        initialize_mini_gop_activity_array): a long pyramid only pays when
        its base predicts the whole span, so high-motion spans halve
        recursively (min 4 frames). Activity = mean abs 1/4-res difference
        between the span's endpoints (the DG detector's HME-distortion
        proxy)."""
        cfg = self.config
        if not cfg.enable_dg or len(buf) < 8:
            return [buf]
        from svt_av1_psy_tpu.codec.me import decimate

        bd = cfg.input_depth

        def activity(a, b):
            a8 = (np.asarray(a) >> (bd - 8)).astype(np.uint8)
            b8 = (np.asarray(b) >> (bd - 8)).astype(np.uint8)
            d = (decimate(a8, 2).astype(np.int32)
                 - decimate(b8, 2).astype(np.int32))
            return float(np.abs(d).mean())

        def split(part):
            if len(part) < 8 or activity(part[0][0], part[-1][0]) < 14.0:
                return [part]
            mid = len(part) // 2
            return split(part[:mid]) + split(part[mid:])

        return split(buf)

    def _queue_gop(self, buf):
        """Kick off the device search for this GoP, hold it, and commit
        the previous GoP (whose search has been running meanwhile) — the
        two-stage search/commit pipeline replacing the reference's SRM
        stage concurrency."""
        cfg = self.config
        if cfg.enable_tf and cfg.tf_strength > 0 and len(buf) >= 4:
            # ALTREF temporal filtering: the mini-GoP top is the long-term
            # reference every other frame predicts from — filter it against
            # its GoP neighbors (+ lookahead future frames when buffered),
            # the reference's alt-ref TF (temporal_filtering.c, dispatched
            # from pd_process for base-layer/ALTREF pictures)
            from .codec.temporal_filter import temporal_filter
            from svt_av1_psy_tpu.profiling import stage as _st

            y, u, v, pts = buf[-1]
            neighbors = [(f[0], f[1], f[2]) for f in buf[-4:-1]]
            neighbors += [(f[0], f[1], f[2])
                          for f in list(self._la_queue)[:3]]
            with _st("tf"):
                fy, fu, fv = temporal_filter(
                    (y, u, v), neighbors, cfg.tf_strength, cfg.input_depth,
                    backend=cfg.tf_backend, device=self.device)
            buf = list(buf[:-1]) + [(fy, fu, fv, pts)]
        prefetch = self._prefetch_gop(buf) if self._use_device_me else None
        self._pending_gops.append((buf, prefetch))
        self._queue_base_src = buf[-1][0]
        while len(self._pending_gops) > 1:
            b, p = self._pending_gops.pop(0)
            self._encode_gop(b, prefetch=p)

    def _drain_gop(self):
        """Encode any buffered frames (partial GoP at a key boundary or
        EOS) as a smaller pyramid, plus every held GoP."""
        buf, self._gop_buf = self._gop_buf, []
        if buf:
            self._queue_gop(buf)
        while self._pending_gops:
            b, p = self._pending_gops.pop(0)
            self._encode_gop(b, prefetch=p)

    def _prefetch_gop(self, buf):
        """Assemble + submit the open-loop device search jobs for one GoP
        (references are SOURCE frames — the reference encoder's own
        open-loop ME choice, me_process.c:97). Returns {display_idx:
        (key, gm_mv)} used by _encode_gop's commits."""
        cfg = self.config
        base_src = self._queue_base_src
        if base_src is None or self._me_pipe is None:
            return None
        from svt_av1_psy_tpu.codec.rd import lambda_sse_per_bit

        frames = [np.asarray(base_src)] + [np.asarray(f[0]) for f in buf]
        n = len(buf)
        self._gop_seq += 1
        seq = self._gop_seq
        qbase = (_crf_to_qindex(cfg.crf)
                 if cfg.rate_control_mode == RateControlMode.CRF_CQP
                 else int(np.clip(cfg.qp * 4, 1, 255)))
        OFF = (0, 10, 16, 18, 20)
        do_gm = cfg.enable_global_motion and self._pc.gm
        jobs, keys = [], {}

        def add(idx, lo, hi, depth):
            q = int(np.clip(qbase + OFF[min(depth, 4)], 1, 255))
            gm = (0, 0)
            if do_gm:
                from svt_av1_psy_tpu.codec.global_motion import estimate_global_translation

                gm = estimate_global_translation(frames[lo], frames[idx],
                                                 cfg.input_depth)
                gm = (int(np.clip(gm[0], -255, 255)),
                      int(np.clip(gm[1], -255, 255)))
            bias = 100
            if int(cfg.tune) == 3:
                pqp = q >> 2
                uni = 85 if pqp < 16 else (95 if pqp < 48 else 100)
                if hi is not None:
                    bi = 115 if pqp < 16 else (105 if pqp < 48 else 100)
                    bias = uni * bi // 100
                else:
                    bias = uni
            lam = 0.35 * float(lambda_sse_per_bit(q, cfg.input_depth, "p"))
            key = (seq, idx)
            jobs.append(dict(key=key, src=idx, ref_l=lo, ref_a=hi, gm=gm,
                             lam=lam, psy_rd=float(cfg.psy_rd),
                             bias_pct=float(bias)))
            # base-layer jobs (no future ref) carry the GoP-chained
            # long-term reference: their recon persists as the next GoP's
            # d0, so open-loop decision error compounds across GoPs —
            # treat them as infinitely "far" for the backend gate
            dist = max(idx - lo, hi - idx) if hi is not None else (1 << 20)
            keys[idx] = (key, gm, dist)

        def walk(lo, hi, depth):
            if hi - lo == 1:
                return
            if hi - lo == 2:
                add(lo + 1, lo, hi, 4)
                return
            mid = (lo + hi) // 2
            add(mid, lo, hi, depth)
            walk(lo, mid, depth + 1)
            walk(mid, hi, depth + 1)

        add(n, 0, None, 0)
        walk(0, n, 1)
        self._me_pipe.submit(frames, jobs)
        return keys

    def _encode_gop(self, buf, prefetch=None):
        """Dyadic pyramid over n display frames d1..dn (d0 = previous base
        recon). Coding order: dn first (unshown base-layer ALTREF), then a
        recursive bisection — interval midpoints code as unshown B frames,
        length-2 intervals code their single frame as a shown leaf, and
        show_existing_frame realizes the display order. Every block predicts
        single-ref (LAST past / ALTREF future); no compound. DPB slots are
        allocated per live node (depth+2 <= 8 up to 32-frame GoPs)."""
        n = len(buf)
        pf = prefetch or {}
        disp_base = self._disp_idx
        if n == 1:
            y, u, v, pts = buf[0]
            scratch = 2 if self._last_slot != 2 else 3
            self._encode_frame(y, u, v, pts, gop=dict(
                show=True, last=self._ref_planes, future=None,
                refresh=1 << scratch, last_slot=self._last_slot,
                future_slot=None, q_offset=0, update_last=True,
                layer=0, prefetch=pf.get(1), disp=disp_base))
            self._last_slot = scratch
            self._disp_idx = disp_base + 1
            return
        free = [s for s in range(8) if s not in (self._last_slot, 1)]
        slots = {0: self._last_slot}
        recs = {0: self._ref_planes}
        disp = {}
        OFF = (0, 10, 16, 18, 20)   # q offset per pyramid depth

        # TPL propagation for the base layer: the GoP top is the reference
        # every other frame predicts from; rate its importance (r0) against
        # the frames that will depend on it and boost its q accordingly
        # (rc_process.c:864, r0_weight BASE = 0.9)
        tpl_r0 = None
        cfg = self.config
        from svt_av1_psy_tpu.config import RateControlMode as _RCM

        if (cfg.enable_tpl_la and self._pc.tpl and n >= 4
                and cfg.rate_control_mode == _RCM.CRF_CQP):
            from .rc.tpl import tpl_analysis

            deps = [buf[i][0] for i in
                    sorted({0, (n - 1) // 2, max(n - 2, 0)})][:3]
            from svt_av1_psy_tpu.profiling import stage as _st

            with _st("host:tpl"):
                tpl_r0 = tpl_analysis([buf[n - 1][0]] + deps,
                                      cfg.input_depth,
                                      backend=cfg.tpl_backend,
                                      device=self.device)[0]

        def enc_unshown(idx, lo, hi, depth):
            slot = free.pop()
            r, rec = self._encode_frame(*buf[idx - 1], gop=dict(
                show=False, last=recs[lo],
                future=(recs[hi] if hi is not None else None),
                refresh=1 << slot, last_slot=slots[lo],
                future_slot=(slots[hi] if hi is not None else None),
                q_offset=OFF[min(depth, 4)], update_last=False,
                layer=depth,
                dists=(idx - lo, (hi - idx) if hi is not None else 1),
                tpl_r0=(tpl_r0 if depth == 0 else None),
                # third reference: the GoP anchor (d0) as GOLDEN where it
                # is not already LAST (7-ref roles, pd_process.c:1030)
                golden=(recs[0] if lo > 0 else None),
                golden_slot=(slots[0] if lo > 0 else None),
                golden_dist=idx,
                prefetch=pf.get(idx), disp=disp_base + idx - 1))
            slots[idx], recs[idx], disp[idx] = slot, r, rec

        def walk(lo, hi, depth):
            if hi - lo == 1:
                return
            if hi - lo == 2:       # single shown leaf at display lo+1
                self._encode_frame(*buf[lo], gop=dict(
                    show=True, last=recs[lo], future=recs[hi], refresh=0,
                    last_slot=slots[lo], future_slot=slots[hi],
                    q_offset=OFF[4], update_last=False, dists=(1, 1),
                    layer=depth, prefetch=pf.get(lo + 1),
                    golden=(recs[0] if lo > 0 else None),
                    golden_slot=(slots[0] if lo > 0 else None),
                    golden_dist=lo + 1,
                    disp=disp_base + lo))
                return
            mid = (lo + hi) // 2
            enc_unshown(mid, lo, hi, depth)
            walk(lo, mid, depth + 1)
            self._emit_show_existing(slots[mid], buf[mid - 1][3], disp[mid])
            walk(mid, hi, depth + 1)
            free.append(slots.pop(mid))
            recs.pop(mid)

        enc_unshown(n, 0, None, 0)
        walk(0, n, 1)
        self._emit_show_existing(slots[n], buf[n - 1][3], disp[n])
        self._ref_planes = recs[n]
        self._last_slot = slots[n]
        self._disp_idx = disp_base + n

    def _emit_show_existing(self, slot, pts, recon):
        """Display a previously decoded (showable) frame from a DPB slot."""
        from svt_av1_psy_tpu.bitstream.obu import show_existing_frame_obu, temporal_delimiter_obu

        payload = temporal_delimiter_obu() + show_existing_frame_obu(slot)
        self._packets.append(Packet(
            payload, pts if pts is not None else self._frame_count,
            recon=recon if self.config.recon_enabled else None))
        self._spent_bits += len(payload) * 8

    def _encode_frame(self, y: np.ndarray, u=None, v=None,
                      pts: Optional[int] = None, gop: Optional[dict] = None,
                      _recode=None):
        """Encode one frame. `gop` (hierarchical scheduling, _encode_gop4):
        is_key (force), show, last (LAST ref planes), future (ALTREF recon
        planes), refresh (refresh_frame_flags), last_slot / future_slot
        (DPB indices for ref_frame_idx), q_offset (layer delta),
        update_last (advance the LAST chain). Returns (ref_planes, recon).
        `_recode` = (attempt, forced_qindex) on an overshoot re-encode
        (rc_process.c recode loop)."""
        cfg = self.config
        _in_y, _in_u, _in_v = y, u, v        # pre-superres originals
        # DPB state snapshot, restored on a recode retry (the first
        # attempt overwrites these with its own recon before the
        # bitstream size is known)
        _in_ipp_hist = list(self._ipp_hist)
        _in_refs = self._ref_planes
        _in_golden = self._golden_planes
        _in_prev_mv = getattr(self, "_prev_mv_grid", None)
        # effective tile split: spec minimums (4096-px width / 4096*2304 area
        # caps) may force more tiles than requested (spec 5.9.15 clamp)
        from svt_av1_psy_tpu.bitstream.obu import clamp_tile_log2s

        tile_cols_log2, tile_rows_log2 = clamp_tile_log2s(
            cfg.width, cfg.height, cfg.tile_columns, cfg.tile_rows)
        if cfg.avif and self._frame_count > 0:
            # single-picture guard (enc_handle.c:5453)
            raise SvtAv1Error(ErrorCode.ERROR_BAD_PARAMETER, "avif mode accepts one picture")
        # GoP: key frame at start, every intra_period+1 frames, and on scene
        # changes (pd_process.c scene_change analog). Under hierarchical
        # scheduling (_submit) the decision was made in display order.
        if gop is not None:
            is_key = bool(gop.get("is_key", False))
        else:
            ip = cfg.intra_period_length
            is_key = (self._frame_count == 0 or self._ref_planes is None
                      or (ip >= 0 and self._frames_since_key > ip))
            if not is_key and cfg.scene_change_detection and self._pc.scene_change:
                from svt_av1_psy_tpu.codec.scene_change import detect_scene_change

                if detect_scene_change(self._prev_src_y, np.asarray(y), cfg.input_depth):
                    is_key = True
            self._prev_src_y = np.asarray(y).copy()
        last_planes = (gop.get("last") if gop is not None else None) \
            or self._ref_planes
        # screen-content tools flag (--scm): 0 off, 1 on, 2 content detect
        # (svt_aom_is_screen_content_psy); detection runs on key frames and
        # holds until the next key
        if cfg.screen_content_mode == 1:
            self._allow_sct = True
        elif cfg.screen_content_mode == 2 and is_key:
            from svt_av1_psy_tpu.codec.screen_content import detect_screen_content

            sc0, _sc1 = detect_screen_content(np.asarray(y), cfg.input_depth)
            self._allow_sct = sc0
        elif cfg.screen_content_mode == 0:
            self._allow_sct = False
        if cfg.lossless:
            # palette/IBC syntax surfaces are not wired into the WHT walk
            self._allow_sct = False
        # ---- super-resolution (key frames: encode at a downscaled width,
        # the decoder upscales normatively before loop restoration; inter
        # frames reference the upscaled recon at full size, so no scaled-MC
        # path is needed — spec 5.9.8 superres_params, super_res.c)
        full_w = cfg.width
        sr_denom = 8
        y_full = u_full = v_full = None
        if is_key and int(cfg.superres_mode) != 0:
            from svt_av1_psy_tpu.codec.superres import downscale_plane, scaled_width

            mode = int(cfg.superres_mode)
            if mode == 1:        # FIXED
                denom = int(cfg.superres_kf_denom)
            elif mode == 2:      # RANDOM (super_res.c SUPERRES_RANDOM):
                # deterministic per-key LCG so streams reproduce
                seed = (self._frame_count * 2654435761 + 0x9E37) & 0xFFFFFFFF
                denom = 9 + (seed >> 13) % 8
            elif mode == 3:      # QTHRESH (get_superres_denom_for_qindex)
                q_est = _crf_to_qindex(cfg.crf) \
                    if cfg.rate_control_mode == RateControlMode.CRF_CQP \
                    else getattr(self, "_last_qindex", 128)
                thr = int(cfg.superres_kf_qthres) * 4
                if q_est < thr:
                    denom = 8
                else:
                    denom = 8 + int(round(8 * min(
                        (q_est - thr) / max(255 - thr, 1), 1.0)))
            else:                # AUTO (super_res.c:284; tune-3 energy
                # threshold, resize.c:1177): low horizontal detail means
                # the normative upscale loses little — downscale more
                y8 = (np.asarray(y) >> (cfg.input_depth - 8)) \
                    .astype(np.int32)
                hdiff = float(np.abs(np.diff(y8[:, ::2], axis=1)).mean())
                vdiff = float(np.abs(np.diff(y8[::2], axis=0)).mean())
                ratio = hdiff / max(vdiff, 1e-3)
                denom = 8 if ratio > 1.25 else (10 if ratio > 0.9 else 12)
            dw = scaled_width(full_w, denom)
            if 9 <= denom <= 16 and 16 <= dw < full_w:
                sr_denom = denom
                y_full, u_full, v_full = np.asarray(y), u, v
                import copy as _copy

                cfg = _copy.copy(cfg)
                cfg.width = dw
                y = downscale_plane(y_full, dw, cfg.input_depth)
                if u is not None:
                    cdw = (dw + 1) >> 1
                    u = downscale_plane(np.asarray(u_full), cdw, cfg.input_depth)
                    v = downscale_plane(np.asarray(v_full), cdw, cfg.input_depth)
                tile_cols_log2, tile_rows_log2 = clamp_tile_log2s(
                    cfg.width, cfg.height, cfg.tile_columns, cfg.tile_rows)
        # rate control: CRF mapping (+ PSY qp-scale-compress) or 1-pass VBR/CBR
        rc_target_bits = None
        if cfg.rate_control_mode == RateControlMode.CRF_CQP:
            qindex = _crf_to_qindex(cfg.crf)
            if self._tpl is not None and is_key:
                # TPL-driven keyframe boost (rc_process.c:872) supersedes the
                # fixed qp-scale-compress curve when lookahead stats exist
                from svt_av1_psy_tpu.rc.rate_control import QP_SCALE_COMPRESS_WEIGHT
                from svt_av1_psy_tpu.rc.tpl import tpl_qindex

                w = QP_SCALE_COMPRESS_WEIGHT[
                    int(min(max(cfg.qp_scale_compress_strength, 0), 3))]
                qindex = tpl_qindex(qindex, self._tpl[0], cfg.input_depth, w)
            elif cfg.qp_scale_compress_strength > 0:
                from svt_av1_psy_tpu.rc.rate_control import qp_scale_compress_qindex

                qindex = qp_scale_compress_qindex(
                    qindex, cfg.qp_scale_compress_strength, cfg.input_depth, is_key)
            if cfg.max_bit_rate and getattr(self, "_mbr_qadj", 0) \
                    and qindex > 1:
                # capped CRF: the leaky-bucket overshoot penalty (see the
                # post-encode feedback below) raises qindex while the
                # rolling rate exceeds --mbr
                qindex = int(np.clip(qindex + self._mbr_qadj, 1, 255))
        else:
            if self._rc is None:
                from svt_av1_psy_tpu.rc.rate_control import RateControl

                self._rc = RateControl(
                    target_bit_rate=cfg.target_bit_rate,
                    fps=cfg.fps_num / max(cfg.fps_denom, 1),
                    width=cfg.width, height=cfg.height, bd=cfg.input_depth,
                    cbr=cfg.rate_control_mode == RateControlMode.CBR,
                    undershoot_pct=cfg.undershoot_pct,
                    overshoot_pct=cfg.overshoot_pct, buf_sz_ms=cfg.buf_sz,
                    buf_initial_ms=cfg.buf_initial_sz,
                    buf_optimal_ms=cfg.buf_optimal_sz,
                    vbv_bufsize=cfg.vbv_bufsize,
                    min_section_pct=cfg.minsection_pct,
                    max_section_pct=cfg.maxsection_pct)
            target = None
            if self._budgets is not None and self._frame_count < len(self._budgets):
                # rescale the remaining plan by the remaining allowance so
                # the aggregate converges to the target even when the
                # correction factor lags complexity jumps
                i = self._frame_count
                remaining_plan = sum(self._budgets[i:])
                total_plan = sum(self._budgets)
                allowance = total_plan - self._spent_bits
                scale = 1.0
                if remaining_plan > 0:
                    scale = min(max(allowance / remaining_plan, 0.2), 3.0)
                target = self._budgets[i] * scale
            qindex = self._rc.frame_qindex(is_key, target_bits=target)
            rc_target_bits = target if target is not None \
                else self._rc._target_bits(is_key)
        if cfg.luminance_qp_bias and not is_key and qindex > 1:
            # PSY frame-luma-bias (rc_process.c:3407-3417): darker frames get
            # more bitrate; zero on temporal layer 0 (the tl*4 factor in the
            # formula), our IPP inter frames behave as layer 1
            y8 = (np.asarray(y) >> (cfg.input_depth - 8)).astype(np.float64)
            avg_luma = float(y8.mean())
            denom = 1024.0 / (1 * 4 * (0.01 * cfg.luminance_qp_bias))
            qindex += int(np.rint(-np.sqrt((255.0 - avg_luma) / denom)
                                  * (qindex / 8.0)))
            qindex = int(np.clip(qindex, 1, 255))
        if gop is not None and gop.get("tpl_r0") is not None and qindex > 1:
            # TPL base-layer boost (crf_qindex_calc, r0_weight[BASE] = 0.9)
            from svt_av1_psy_tpu.rc.tpl import tpl_qindex

            qindex = tpl_qindex(qindex, gop["tpl_r0"], cfg.input_depth,
                                weight=0.9)
        if gop is not None and not is_key and qindex > 1:
            # temporal-layer delta (pyramid base boosted, leaves cheapened);
            # --use-fixed-qindex-offsets replaces (1) or stacks on (2) the
            # derived ladder with the user's per-layer offsets
            # (enc_settings.c qindex_offsets[] handling)
            off = int(gop.get("q_offset") or 0)
            if cfg.use_fixed_qindex_offsets and cfg.qindex_offsets:
                lay = int(gop.get("layer", 0))
                u_off = int(cfg.qindex_offsets[
                    min(lay, len(cfg.qindex_offsets) - 1)])
                off = u_off if cfg.use_fixed_qindex_offsets == 1 \
                    else off + u_off
            if off:
                qindex = int(np.clip(qindex + off, 1, 255))
        if is_key and cfg.use_fixed_qindex_offsets \
                and cfg.key_frame_qindex_offset and qindex > 1:
            qindex = int(np.clip(
                qindex + int(cfg.key_frame_qindex_offset), 1, 255))
        if cfg.startup_qp_offset and qindex > 1 and not is_key \
                and self._frame_count <= (1 << cfg.hierarchical_levels):
            # --startup-qp-offset: extra offset while the first mini-GoP
            # establishes references (enc_settings.c startup_qp_offset)
            qindex = int(np.clip(qindex + int(cfg.startup_qp_offset) * 4,
                                 1, 255))
        if qindex > 1 and (cfg.min_qp_allowed > 1 or cfg.max_qp_allowed < 63):
            # --min-qp/--max-qp clamp the final RC output (rc_process.c
            # qindex clamping; qp units scale x4 to qindex)
            qindex = int(np.clip(qindex, cfg.min_qp_allowed * 4,
                                 cfg.max_qp_allowed * 4))
        if _recode is not None:
            # overshoot re-encode: force the bumped qindex past every
            # modifier (they already shaped the first attempt's value)
            qindex = int(_recode[1])
        sb_qindex_map = None
        if (self._tpl is not None and is_key and qindex > 1 and sr_denom == 8
                and not (cfg.enable_variance_boost and cfg.aq_mode == 2)):
            from svt_av1_psy_tpu.rc.tpl import tpl_sb_qindex_map

            sb_rows = -(-cfg.height // 64)
            sb_cols = -(-cfg.width // 64)
            sb_qindex_map = tpl_sb_qindex_map(qindex, self._tpl[1], sb_rows,
                                              sb_cols, cfg.input_depth,
                                              unit_px=self._tpl[2])
            if np.all(sb_qindex_map == qindex):
                sb_qindex_map = None
        if self._tpl is not None:
            self._tpl = None
        def frame_variances():
            from svt_av1_psy_tpu.psy.variance_boost import sb_variances_8x8

            ph = -(-cfg.height // 64) * 64
            pw = -(-cfg.width // 64) * 64
            # PA variance statistics are 8-bit-domain (pic_analysis_process.c)
            y8 = (np.asarray(y) >> (cfg.input_depth - 8)).astype(np.uint8)
            padded = np.zeros((ph, pw), np.uint8)
            padded[: cfg.height, : cfg.width] = y8
            padded[: cfg.height, cfg.width :] = y8[:, -1:]
            padded[cfg.height :, :] = padded[cfg.height - 1 : cfg.height, :]
            return sb_variances_8x8(padded)

        seg_params = sb_seg_map = None
        if cfg.aq_mode == 1 and qindex > 1:
            from svt_av1_psy_tpu.codec.segmentation import assign_segments_by_variance

            seg_params, sb_seg_map = assign_segments_by_variance(frame_variances())
        if cfg.enable_variance_boost and cfg.aq_mode == 2 and qindex > 1:
            from svt_av1_psy_tpu.psy.variance_boost import variance_adjust_qp

            qindex, sb_qindex_map = variance_adjust_qp(
                qindex, frame_variances(), cfg.variance_boost_strength,
                cfg.input_depth, cfg.variance_octile,
                int(cfg.variance_boost_curve))
        from svt_av1_psy_tpu.codec.qm import frame_qm_levels

        if sb_qindex_map is not None \
                and (cfg.min_qp_allowed > 1 or cfg.max_qp_allowed < 63):
            sb_qindex_map = np.clip(sb_qindex_map, cfg.min_qp_allowed * 4,
                                    cfg.max_qp_allowed * 4)
        # extended CRF (63.25-70 + quarter steps): qindex_offset =
        # crf*4 - qp*4 with qp = min(63, floor(crf)) (enc_settings.c:1518)
        ext_off = int(round(float(cfg.crf) * 4)) - min(63, int(cfg.crf)) * 4
        chroma_delta = _chroma_qindex_delta(qindex, int(cfg.tune),
                                            cfg.color_primaries, ext_off)
        if cfg.use_fixed_qindex_offsets:
            # per-layer / key-frame chroma offsets stack on the tune delta
            # (enc_settings.c chroma_qindex_offsets[])
            if is_key:
                chroma_delta += int(cfg.key_frame_chroma_qindex_offset)
            elif cfg.chroma_qindex_offsets:
                lay = int(gop.get("layer", 0)) if gop is not None else 0
                chroma_delta += int(cfg.chroma_qindex_offsets[
                    min(lay, len(cfg.chroma_qindex_offsets) - 1)])
            chroma_delta = int(np.clip(chroma_delta, -63, 63))
        # per-plane DC/AC qindex offsets (EbSvtAv1Enc.h luma_y_dc_/
        # chroma_*_qindex_offset): the same values feed the quantizers and
        # the frame header's delta_q fields, so streams stay conformant
        _cl = lambda o: int(np.clip(o, -63, 63))
        plane_dq = (_cl(cfg.luma_y_dc_qindex_offset),
                    _cl(chroma_delta + cfg.chroma_u_dc_qindex_offset),
                    _cl(chroma_delta + cfg.chroma_u_ac_qindex_offset),
                    _cl(chroma_delta + cfg.chroma_v_dc_qindex_offset),
                    _cl(chroma_delta + cfg.chroma_v_ac_qindex_offset))
        qm_levels = frame_qm_levels(cfg, qindex, plane_dq[2], plane_dq[4])
        if cfg.lossless:
            # lossless (EbSvtAv1Enc.h:940): CodedLossless requires qindex 0
            # with zero dc/ac delta_q in every plane and no per-SB deltas
            # (spec coded_lossless); the intra walk's WHT-4x4 path engages
            # at qindex 0 (intra_encoder._encode_block_lossless)
            qindex = 0
            sb_qindex_map = None
            seg_params = sb_seg_map = None
            chroma_delta = 0
            plane_dq = (0, 0, 0, 0, 0)
            qm_levels = None
        common = dict(bd=cfg.input_depth, monochrome=self._seq.monochrome,
                      sharpness=cfg.sharpness, sb_qindex_map=sb_qindex_map,
                      qm_levels=qm_levels, psy_rd=cfg.psy_rd,
                      seg_params=seg_params, sb_seg_map=sb_seg_map,
                      noise_norm=cfg.noise_norm_strength,
                      enable_filter_intra=True, chroma_delta=chroma_delta,
                      plane_dq=plane_dq,
                      mode_candidates=self._intra_mode_candidates(),
                      allow_sct=getattr(self, "_allow_sct", False),
                      palette_level=cfg.palette_level)
        gm_mv = (0, 0)
        gm_wm = None
        prefetch = gop.get("prefetch") if gop is not None else None
        if not is_key and cfg.enable_global_motion and self._pc.gm:
            vh, vw = cfg.height, cfg.width
            if prefetch is not None:
                # the open-loop (source-vs-source) estimate the device
                # search already used; the commit must agree with it
                gm_mv = tuple(prefetch[1])
            else:
                from svt_av1_psy_tpu.codec.global_motion import estimate_global_translation

                gm_mv = estimate_global_translation(
                    last_planes[0][:vh, :vw], np.asarray(y), cfg.input_depth)
                # clamp to the TRANSLATION-only codable range: the header
                # codes wmmat>>prec_diff with a (1<<trans_bits)+1 subexp
                # alphabet around the identity ref, so |mv_q3| must stay
                # below 1<<(trans_bits-1)
                gm_mv = (int(np.clip(gm_mv[0], -255, 255)),
                         int(np.clip(gm_mv[1], -255, 255)))
            if (cfg.preset <= 6 and not getattr(self, "_allow_sct", False)):
                # ROTZOOM upgrade (gm_level analog): LS fit over a block
                # motion field, accepted only when it clearly beats the
                # translation model (codec/global_motion.py)
                from svt_av1_psy_tpu.codec.global_motion import estimate_global_rotzoom

                gm_wm = estimate_global_rotzoom(
                    last_planes[0][:vh, :vw], np.asarray(y),
                    cfg.input_depth, base_mv=gm_mv)

        # OBMC (motion_mode OBMC_CAUSAL): switchable on inter frames at the
        # slower presets, single tile (enc_mode_config obmc_level analog)
        mm_switchable = (not is_key and cfg.preset <= 6
                         and tile_cols_log2 == 0 and tile_rows_log2 == 0)

        # switchable interpolation filters: per-block filter syntax on the
        # Python-walk presets (read_interpolation_filter; dual filter off);
        # --fast-decode >= 1 pins EIGHTTAP_REGULAR (cheaper decoder MC)
        filt_switchable = (not is_key and cfg.preset <= 6
                           and cfg.fast_decode == 0
                           and tile_cols_log2 == 0 and tile_rows_log2 == 0)

        # IBC (intra block copy): screen-content key frames; the spec turns
        # ALL in-loop filters off for intrabc frames (intra_bc_tools,
        # EbCodingUnit allow_intrabc; frame header reads allow_intrabc only
        # when allow_screen_content_tools)
        allow_ibc = (is_key and getattr(self, "_allow_sct", False)
                     and cfg.preset <= 6 and sr_denom == 8
                     and cfg.intrabc_mode != 0)

        # PSY tune 3 (subjective SSIM): unipred psy bias on inter costs
        # (uni_psy_bias/bi_psy_bias, md_process.h:1277; mode_decision.c:4263)
        inter_bias_pct = 100
        if int(cfg.tune) == 3:
            pqp = qindex >> 2
            uni = 85 if pqp < 16 else (95 if pqp < 48 else 100)
            if gop is not None and gop.get("future") is not None:
                bi = 115 if pqp < 16 else (105 if pqp < 48 else 100)
                inter_bias_pct = uni * bi // 100
            else:
                inter_bias_pct = uni
        # PSY tune 4 (still picture): lambda weight 128 -> up to 200 with
        # QP ramps (enc_mode_config.c:8843)
        lambda_scale = 1.0
        if int(cfg.tune) == 4:
            pqp = qindex >> 2
            lambda_scale = (min(max(min(pqp * 4, (63 - pqp) * 3), 0), 72)
                            + 128) / 128.0

        # open-loop device RDO search (partition tree + modes + tx types);
        # the conformant encode pass below executes these decisions
        decisions = None
        if is_key and self._pc.rdo and qindex > 0:
            from .codec.intra_rdo import search_intra_decisions

            ph = -(-cfg.height // 64) * 64
            pw = -(-cfg.width // 64) * 64
            padded = np.zeros((ph, pw), np.uint16)
            padded[: cfg.height, : cfg.width] = np.asarray(y)
            padded[: cfg.height, cfg.width:] = padded[: cfg.height,
                                                      cfg.width - 1: cfg.width]
            padded[cfg.height:, :] = padded[cfg.height - 1: cfg.height, :]
            search_qmap = sb_qindex_map
            if search_qmap is None and seg_params is not None:
                # segmentation ALT_Q moves the block qindex; feed the search
                # the effective per-SB map so lambda/distortion line up
                search_qmap = np.vectorize(
                    lambda s: seg_params.seg_qindex(qindex, int(s)))(sb_seg_map)
            depths = self._pc.depths
            if cfg.max_32_tx_size and 64 in depths:
                # PSY max-32-tx-size: with TX_MODE_LARGEST, capping the leaf
                # at 32x32 caps the transform at 32x32 (EbSvtAv1Enc.h:970)
                depths = tuple(d for d in depths if d <= 32)
            decisions = search_intra_decisions(
                padded, qindex, bd=cfg.input_depth, sb_qindex_map=search_qmap,
                qm_levels=qm_levels, depths=depths,
                tx_search_depths=self._pc.tx_search_depths,
                lambda_scale=lambda_scale,
                psy_knobs=(int(cfg.spy_rd), float(cfg.psy_rd),
                           bool(cfg.sharp_tx)),
                device=self.device)

        if not hasattr(self, "_ref_me_cache"):
            self._ref_me_cache = {}
        inter_shared = {"ref_cache": self._ref_me_cache,
                        "torch_device": self.device}
        import os as _os

        from svt_av1_psy_tpu.codec import mc_native as _mc_native

        if self._use_device_me and (_os.environ.get("SVT_TPU_CLOSED_DECIDE")
                                    or not _mc_native.available()):
            # frames whose open-loop device rows are not trusted run the
            # device ladder CLOSED-loop (recon refs) instead of the native
            # decide (inter_encoder._closed_device_rows). Default only
            # when the native kernel is absent: measured at 480p p6 x33 it
            # recovers +1.0 dB of the open-loop gap (27.29 -> 28.29) but
            # still trails the native closed-loop decide (28.94), so with
            # the C library present the hybrid keeps native for referenced
            # frames. (A device-partition/native-leaves split was also
            # measured and rejected: -1.85 dB at 480p.)
            inter_shared["closed_device_decide"] = True
        if prefetch is not None and self._me_pipe is not None and not is_key:
            # always fetch (drains the pipeline's result slot), then gate:
            # at quality presets the device rows are the decision source
            # only for SHORT pyramid intervals, where A/B shows them at or
            # above the native kernel; long intervals (deep-GoP base/mid
            # layers) keep the closed-loop native decide, whose recon-ref
            # costs the open-loop search cannot model (tools/ab_search.py:
            # device -1.4dB at interval 16, +0.25dB at interval <= 2)
            rows = self._me_pipe.get(prefetch[0])
            dist = prefetch[2] if len(prefetch) > 2 else 0
            if dist <= self._dev_me_max_dist:
                inter_shared["device_rows"] = rows
            else:
                # long-interval frames: the device full-pel MVs become
                # per-block SEEDS for the closed-loop native kernel, which
                # then searches a much smaller range (the device HME
                # already covered the reach)
                inter_shared["device_seed_rows"] = rows

        # ---- IPP second reference: LAST2 (previous LAST, alternating DPB
        # slots 0/2) vs the GOLDEN key frame, picked by decimated SAD
        # (pic_manager multi-ref lists, pic_manager_process.c:305)
        ipp_ref2_planes = None
        ipp_ref2_const = 4          # GOLDEN_FRAME
        ipp_ref2_dist = 6
        if not is_key and gop is None:
            from svt_av1_psy_tpu.codec.me import decimate

            ipp_ref2_planes = self._golden_planes
            if len(self._ipp_hist) >= 2:
                last2_planes = self._ipp_hist[-2][1]
                if self._golden_planes is None:
                    pick_l2 = True
                else:
                    vh, vw = cfg.height, cfg.width
                    cq = decimate(np.asarray(y)[:vh, :vw].astype(np.uint16), 2)
                    gq = decimate(self._golden_planes[0][:vh, :vw]
                                  .astype(np.uint16), 2)
                    lq = decimate(last2_planes[0][:vh, :vw]
                                  .astype(np.uint16), 2)
                    pick_l2 = (np.abs(cq.astype(np.int32) - lq).sum()
                               < np.abs(cq.astype(np.int32) - gq).sum())
                if pick_l2:
                    ipp_ref2_planes = last2_planes
                    ipp_ref2_const = 2    # LAST2_FRAME
                    ipp_ref2_dist = 2

        # ---- order hints (decode side: RefOrderHint / sign bias /
        # skip-mode derivation all run from these, spec 5.9.2 + 7.8).
        # Display order is the hint source; the DPB mirror tracks what the
        # decoder's RefOrderHint[] holds per slot.
        disp = gop.get("disp") if gop is not None else None
        if disp is None:
            disp = self._disp_idx
            self._disp_idx = disp + 1
        order_hint = disp & ((1 << self._seq.order_hint_bits) - 1)
        if is_key:
            ref_idx_early = (0,) * 7
        elif gop is not None:
            ls = int(gop.get("last_slot", 0))
            idx = [ls] * 7
            fs = gop.get("future_slot")
            if fs is not None:
                idx[6] = int(fs)
            gs = gop.get("golden_slot")
            if gs is not None:
                idx[3] = int(gs)       # GOLDEN = the GoP anchor's slot
            ref_idx_early = tuple(idx)
        else:
            ls = self._ipp_hist[-1][0] if self._ipp_hist else 0
            l2s = (self._ipp_hist[-2][0] if len(self._ipp_hist) >= 2
                   else ls)
            ref_idx_early = (ls, l2s, ls, 1, ls, ls, ls)
        ref_hints = tuple(self._dpb_hints[i] for i in ref_idx_early)
        sign_bias = [0] * 8
        skip_pair = None
        skip_present = False
        if self._seq.enable_order_hint and not is_key:
            from svt_av1_psy_tpu.bitstream.obu import get_relative_dist, skip_mode_frames_raw

            for i in range(7):
                sign_bias[1 + i] = int(get_relative_dist(
                    self._seq, ref_hints[i], order_hint) > 0)
            ref_select_early = (gop is not None
                               and gop.get("future") is not None)
            if ref_select_early and seg_params is None:
                skip_pair = skip_mode_frames_raw(self._seq, order_hint,
                                                 ref_hints)
                # enable the per-block bit only when the derived pair is
                # the pair the mode decision actually searches (LAST +
                # ref2), so conversions can happen; otherwise the bit
                # would be pure rate overhead
                enc_pair = (1, 7)   # LAST + ALTREF (hierarchical B)
                skip_present = skip_pair == enc_pair
        sign_bias = tuple(sign_bias)
        skip_weights = (0, 0)
        if skip_present and self._seq.enable_jnt_comp:
            # with seq enable_jnt_comp, skip-mode blocks predict
            # distance-weighted (compound_idx 0); jnt_comp off -> plain
            # COMPOUND_AVERAGE and (0, 0) signals that to the walk
            from svt_av1_psy_tpu.codec.compound import dist_wtd_weights

            skip_weights = dist_wtd_weights(
                self._seq.order_hint_bits, order_hint,
                ref_hints[skip_pair[0] - 1], ref_hints[skip_pair[1] - 1])

        # ---- temporal MV projection (MFMV, spec 7.9): project the saved
        # motion fields of up to 3 references onto this frame's 8x8 grid;
        # the MV-stack temporal scan consumes it in search + both walks
        use_rfm = bool(self._seq.enable_ref_frame_mvs and not is_key
                       and not cfg.lossless)
        tpl_data = None
        if use_rfm:
            from svt_av1_psy_tpu.codec.mfmv import rel_dist as _rd
            from svt_av1_psy_tpu.codec.mfmv import setup_motion_field

            _mi_r = 2 * ((cfg.height + 7) >> 3)
            _mi_c = 2 * ((cfg.width + 7) >> 3)
            _bits = self._seq.order_hint_bits
            refs_mf = {}
            for _role in range(1, 8):
                _slot = ref_idx_early[_role - 1]
                _e = self._dpb_mf[_slot]
                refs_mf[_role] = _e if _e is not None else {
                    "hint": self._dpb_hints[_slot], "is_intra": True,
                    "ref_hints": (0,) * 7, "mi_rows": 0, "mi_cols": 0,
                    "mf": None}
            _tr, _tc, _to = setup_motion_field(_mi_r, _mi_c, order_hint,
                                               _bits, refs_mf)
            _cur_off = np.zeros(8, np.int32)
            for _i in range(7):
                _cur_off[1 + _i] = _rd(order_hint, ref_hints[_i], _bits)
            tpl_data = dict(row=_tr, col=_tc, off=_to, cur_off=_cur_off,
                            allow_hp=True, force_int=False)

        def make_enc():
            if is_key:
                kw = dict(common)
                if cfg.lossless:
                    from svt_av1_psy_tpu.codec.constants import BlockSize as _BS

                    kw["target_bsize"] = _BS.BLOCK_8X8
                e = IntraFrameEncoder(
                    cfg.width, cfg.height, qindex, decisions=decisions,
                    filter_intra_search=self._pc.filter_intra_search,
                    cfl_search=self._pc.cfl_search, allow_intrabc=allow_ibc,
                    **kw)
                e.sr_denom = sr_denom   # LR unit mapping scales with superres
                return e
            from .codec.inter_encoder import InterFrameEncoder

            return InterFrameEncoder(
                cfg.width, cfg.height, qindex, last_planes, gm_mv=gm_mv,
                golden_planes=(gop.get("golden") if gop is not None
                               else ipp_ref2_planes),
                golden_const=(None if gop is not None else ipp_ref2_const),
                ref3_dist=(int(gop.get("golden_dist") or 1)
                           if gop is not None else 1),
                future_planes=(gop.get("future") if gop is not None else None),
                ref_distances=(gop.get("dists", (1, 1)) if gop is not None
                               else (1, ipp_ref2_dist)),
                ref_select=(gop is not None and gop.get("future") is not None),
                shared=inter_shared,
                inter_depths=self._pc.inter_depths,
                inter_rect=self._pc.inter_rect,
                inter_part4=self._pc.inter_part4,
                gm_wm=gm_wm,
                inter_bias_pct=inter_bias_pct,
                inter_tx_search=len(self._pc.tx_search_depths) > 0,
                tx_size_search=self._pc.tx_size_search,
                motion_mode_switchable=mm_switchable,
                enable_interintra=self._seq.enable_interintra_compound,
                enable_masked_compound=self._seq.enable_masked_compound,
                rdoq_fast=self._pc.rdoq_fast,
                seed_grid=getattr(self, "_prev_mv_grid", None),
                switchable_filters=filt_switchable,
                device_commit=(None if cfg.commit_backend == "auto"
                               else cfg.commit_backend == "device"),
                sign_bias=sign_bias,
                skip_mode_present=skip_present,
                skip_mode_pair=skip_pair,
                skip_mode_weights=skip_weights,
                tpl_mvs=tpl_data,
                **common)

        def run_filters(enc):
            """DLF + CDEF on the encoder's recon; returns the post-DLF copy
            (LR boundary source) and the cdef parameters used."""
            if allow_ibc or qindex == 0:
                # intrabc / CodedLossless frames: loop filters are
                # normatively disabled (spec 5.9.11 / coded_lossless)
                return ([ps.recon.copy() for ps in enc.planes],
                        0, 0, (0, 0), (0, 0), 3)
            lvl_y = lvl_uv = 0
            if cfg.enable_dlf_flag:
                from svt_av1_psy_tpu.codec.deblock import pick_filter_level

                lvl = pick_filter_level(qindex, cfg.input_depth, is_key=True)
                # PSY sharpness raises/lowers deblock strength bias; key
                # frames under tunes 0/3 sharpen by +2 (deblocking_filter.c:1147)
                sharp = max(cfg.sharpness, 0)
                if is_key and int(cfg.tune) in (0, 3):
                    sharp = min(7, sharp + 2)
                lvl_y = int(np.clip(lvl - cfg.sharpness, 0, 63))
                lvl_uv = int(np.clip(lvl_y, 0, 63))
                enc.apply_loop_filter((lvl_y, lvl_y), lvl_uv,
                                      sharpness=sharp)
            deblocked = [ps.recon.copy() for ps in enc.planes]
            cdef_y = cdef_uv = (0, 0)
            cdef_damping = 3
            if self._seq.enable_cdef:
                from .codec.cdef import cdef_frame, pick_cdef_strengths

                pri, sec, cdef_damping = pick_cdef_strengths(
                    np.asarray(y), enc.planes[0].recon, enc.mi_skip, qindex,
                    cfg.input_depth)
                cdef_y = cdef_uv = (pri, min(sec, 3))
                rec = [ps.recon for ps in enc.planes] + [None] * (3 - len(enc.planes))
                cdef_frame(rec[:3], enc.mi_skip, qindex, pri, min(sec, 3), pri,
                           min(sec, 3), cdef_damping, cfg.input_depth,
                           backend=("device"
                                    if cfg.filters_backend == "device"
                                    else "host"), device=self.device)
            return deblocked, lvl_y, lvl_uv, cdef_y, cdef_uv, cdef_damping

        from svt_av1_psy_tpu.profiling import stage as _stage

        def upscale_all(planes_list):
            """Normative horizontal upscale (superres): taps sample the
            mi-aligned recon extent; step/x0 derive from visible widths."""
            from svt_av1_psy_tpu.codec.superres import upscale_plane

            mi_w = (2 * ((cfg.width + 7) >> 3)) * 4   # MiCols * MI_SIZE
            out = []
            for p, arr in enumerate(planes_list):
                ss = 0 if p == 0 else 1
                vh = (cfg.height + ss) >> ss
                vw = (cfg.width + ss) >> ss
                aw = min(mi_w >> ss, arr.shape[1])
                ow = (full_w + ss) >> ss
                out.append(upscale_plane(np.ascontiguousarray(arr[:vh, :aw]),
                                         ow, cfg.input_depth, visible_w=vw))
            return out

        enc = make_enc()
        with _stage("host:encode_pass"):
            tiles = enc.encode_tiles(y, u, v, tile_cols_log2, tile_rows_log2)
        with _stage("host:filters"):
            deblocked, lvl_y, lvl_uv, cdef_y, cdef_uv, cdef_damping = run_filters(enc)
        up_final = None   # superres: full-width post-LR planes
        if sr_denom > 8:
            up_final = upscale_all([ps.recon for ps in enc.planes])
        lr_types = (0, 0, 0)
        if self._seq.enable_restoration and not allow_ibc and qindex > 0:
            from .codec.restoration import RESTORE_NONE, apply_restoration, pick_lr

            # LR operates on the (upscaled, full-width) frame (spec order:
            # deblock -> cdef -> superres upscale -> loop restoration)
            if sr_denom > 8:
                lr_recon = up_final
                lr_deblocked = upscale_all(deblocked)
                lr_src = (y_full, u_full, v_full)
                lr_w = full_w
            else:
                lr_recon = [ps.recon for ps in enc.planes]
                lr_deblocked = deblocked
                lr_src = (y, u, v)
                lr_w = cfg.width
            rsts = [None] * len(enc.planes)
            lr_backend = ("device" if cfg.filters_backend == "device"
                          else "host")
            # 256px luma / 128px chroma units (the reference's
            # RESTORATION_UNITSIZE_MAX sizing): 16x fewer unit searches
            # than 64px units and less coefficient rate
            with _stage("host:lr_search"):
                rsts[0] = pick_lr(np.asarray(lr_src[0]), lr_recon[0],
                                  lr_deblocked[0], lr_w, cfg.height, 0,
                                  cfg.input_depth, unit_size=256,
                                  sgr_eps_step=self._pc.sgr_eps_step,
                                  backend=lr_backend, device=self.device)
                if len(enc.planes) > 1:
                    cw, ch = (lr_w + 1) >> 1, (cfg.height + 1) >> 1
                    for plane, srcp in ((1, lr_src[1]), (2, lr_src[2])):
                        rsts[plane] = pick_lr(
                            np.asarray(srcp), lr_recon[plane],
                            lr_deblocked[plane], cw, ch, 1, cfg.input_depth,
                            unit_size=256,
                            sgr_eps_step=self._pc.sgr_eps_step,
                            backend=lr_backend, device=self.device)
            if any(r is not None and r.frame_type != RESTORE_NONE for r in rsts):
                # LR syntax is coded per SB, so re-encode the tiles with the
                # chosen units (the reference's EncDec/EC split; decisions are
                # deterministic, pass 2 reproduces the identical recon)
                enc = make_enc()
                enc.rsts = rsts
                tiles = enc.encode_tiles(y, u, v, tile_cols_log2, tile_rows_log2)
                deblocked, lvl_y, lvl_uv, cdef_y, cdef_uv, cdef_damping = run_filters(enc)
                if sr_denom > 8:
                    up_final = upscale_all([ps.recon for ps in enc.planes])
                    apply_restoration(up_final, upscale_all(deblocked),
                                      rsts, cfg.input_depth)
                else:
                    apply_restoration([ps.recon for ps in enc.planes], deblocked,
                                      rsts, cfg.input_depth)
                lr_types = tuple((r.frame_type if r is not None else 0)
                                 for r in rsts) + (0,) * (3 - len(rsts))
        from svt_av1_psy_tpu.codec.constants import FrameType

        fg = None
        if self._film_grain is not None:
            import copy

            fg = copy.copy(self._film_grain)
            # decorrelate grain across frames (each frame re-codes its seed)
            fg.random_seed = (fg.random_seed + 3248 * self._frame_count) & 0xFFFF
        fp = FrameParams(base_q_idx=qindex, delta_q_present=sb_qindex_map is not None,
                         tx_mode_select=getattr(enc, "tx_mode_select", False),
                         allow_screen_content_tools=getattr(self, "_allow_sct", False),
                         y_dc_delta_q=plane_dq[0],
                         u_dc_delta_q=plane_dq[1], u_ac_delta_q=plane_dq[2],
                         v_dc_delta_q=plane_dq[3], v_ac_delta_q=plane_dq[4],
                         film_grain=fg, lr_types=lr_types,
                         lr_unit_size=256, lr_uv_unit_size=128,
                         segmentation=seg_params,
                         gm_trans=((gm_mv, None, None, None, None, None, None)
                                   if gm_mv != (0, 0) and gm_wm is None
                                   else None),
                         gm_rotzoom=(tuple(gm_wm) if gm_wm is not None
                                     else None),
                         using_qmatrix=qm_levels is not None,
                         qm_y=qm_levels[0] if qm_levels else 15,
                         qm_u=qm_levels[1] if qm_levels else 15,
                         qm_v=qm_levels[2] if qm_levels else 15,
                         frame_type=FrameType.KEY_FRAME if is_key else FrameType.INTER_FRAME,
                         tile_cols_log2=tile_cols_log2, tile_rows_log2=tile_rows_log2,
                         filter_level=(lvl_y, lvl_y), filter_level_uv=(lvl_uv, lvl_uv),
                         sharpness=(min(7, max(cfg.sharpness, 0) + 2)
                                    if (is_key and int(cfg.tune) in (0, 3)
                                        and cfg.enable_dlf_flag)
                                    else max(cfg.sharpness, 0)),
                         cdef_damping=cdef_damping, cdef_bits=0,
                         cdef_y_strengths=((cdef_y[0], cdef_y[1]),),
                         cdef_uv_strengths=((cdef_uv[0], cdef_uv[1]),),
                         superres_denom=sr_denom,
                         allow_intrabc=allow_ibc,
                         interpolation_filter_switchable=filt_switchable,
                         order_hint=order_hint,
                         ref_order_hints=ref_hints,
                         use_ref_frame_mvs=use_rfm,
                         skip_mode_present=skip_present)
        if not is_key:
            fp.is_motion_mode_switchable = mm_switchable
            if gop is not None:
                # hierarchical scheduling: explicit DPB slot roles
                fp.show_frame = bool(gop.get("show", True))
                fp.showable_frame = not fp.show_frame
                fp.refresh_frame_flags = int(gop.get("refresh", 0))
                ls = int(gop.get("last_slot", 0))
                idx = [ls] * 7
                fs = gop.get("future_slot")
                if fs is not None:
                    idx[6] = int(fs)          # ALTREF
                    fp.reference_select = True
                gs = gop.get("golden_slot")
                if gs is not None:
                    idx[3] = int(gs)          # GOLDEN = the GoP anchor
                fp.ref_frame_idx = tuple(idx)
            else:
                # DPB: LAST alternates slots 0/2 so the previous LAST stays
                # addressable as LAST2; slot 1 = GOLDEN (key frames via 0xFF)
                ls = self._ipp_hist[-1][0] if self._ipp_hist else 0
                l2s = self._ipp_hist[-2][0] if len(self._ipp_hist) >= 2 else ls
                new_slot = 2 if ls == 0 else 0
                fp.refresh_frame_flags = 1 << new_slot
                fp.ref_frame_idx = (ls, l2s, ls, 1, ls, ls, ls)
                self._ipp_new_slot = new_slot
        # temporal ME seeds for the next frame: this frame's coded MV grid
        # (keyframes reset it — their grid is all-intra)
        if is_key:
            self._prev_mv_grid = None
        elif getattr(enc, "grid", None) is not None:
            self._prev_mv_grid = (enc.grid.mv_row.copy(),
                                  enc.grid.mv_col.copy())
        # reference state: final (post-filter) recon planes, aligned dims
        # (superres: the upscaled full-width planes are the reference)
        if up_final is not None:
            ref_planes = [p.copy() for p in up_final]
        else:
            ref_planes = [ps.recon.copy() for ps in enc.planes]
        if gop is None or gop.get("update_last", True):
            self._ref_planes = ref_planes
        if gop is None:
            if is_key:
                self._ipp_hist = [(0, ref_planes)]
            else:
                self._ipp_hist.append((getattr(self, "_ipp_new_slot", 0),
                                       ref_planes))
                self._ipp_hist = self._ipp_hist[-2:]
        if is_key:
            # ref_planes is rebound (never mutated) per frame, so the golden
            # snapshot can alias the key frame's recon list
            self._golden_planes = self._ref_planes
        payload = temporal_delimiter_obu()
        if self._frame_count == 0:
            payload += sequence_header_obu(self._seq)
        if is_key and self._metadata_obus:
            payload += self._metadata_obus
        _t35_key = pts if pts is not None else self._frame_count
        t35_list = self._frame_t35.get(_t35_key)
        if t35_list:
            from svt_av1_psy_tpu.bitstream.obu import metadata_obu
            from svt_av1_psy_tpu.codec.metadata import METADATA_TYPE_ITUT_T35

            for t35 in t35_list:
                payload += metadata_obu(METADATA_TYPE_ITUT_T35, t35)
        payload += frame_obu(self._seq, fp, tiles)
        # ---- overshoot recode loop (rc_process.c recode; --recode-loop):
        # a VBR/CBR frame that blows its budget re-encodes once or twice
        # at a bumped qindex. recode_loop: 1 = key frames only, 2/4 = key
        # + unshown (ARF/base) frames (ALLOW_RECODE_KFARFGF semantics),
        # 3 = all frames.
        if (self._rc is not None and rc_target_bits is not None
                and cfg.recode_loop > 0 and qindex < 255):
            attempt = _recode[0] if _recode is not None else 0
            rl = int(cfg.recode_loop)
            shown_f = is_key or gop is None or bool(gop.get("show", True))
            eligible = (is_key if rl == 1
                        else (is_key or not shown_f) if rl in (2, 4)
                        else True)
            actual = len(payload) * 8
            limit = rc_target_bits * (1.0 + cfg.overshoot_pct / 100.0) * 1.6
            if eligible and attempt < 2 and actual > limit:
                bump = max(4, int(24.0 * np.log2(actual / max(limit, 1.0))))
                self._ipp_hist = _in_ipp_hist
                self._ref_planes = _in_refs
                self._golden_planes = _in_golden
                self._prev_mv_grid = _in_prev_mv
                return self._encode_frame(
                    _in_y, _in_u, _in_v, pts, gop=gop,
                    _recode=(attempt + 1, min(255, qindex + bump)))
        self._frame_t35.pop(_t35_key, None)   # consumed (kept across recodes)
        # motion-field storage (spec 7.20): refreshed slots keep this
        # frame's 8x8 (ref, mv) field for future MFMV projection
        mf_entry = None
        if (self._seq.enable_ref_frame_mvs and not is_key
                and fp.refresh_frame_flags
                and getattr(enc, "grid", None) is not None):
            from svt_av1_psy_tpu.codec.mfmv import rel_dist as _rd2
            from svt_av1_psy_tpu.codec.mfmv import save_motion_field

            _side = np.zeros(8, np.int8)
            for _i in range(7):
                if ref_hints[_i] == order_hint:
                    _side[1 + _i] = -1
                elif _rd2(ref_hints[_i], order_hint,
                          self._seq.order_hint_bits) > 0:
                    _side[1 + _i] = 1
            mf_entry = dict(
                hint=order_hint, ref_hints=ref_hints, is_intra=False,
                mi_rows=enc.grid.rows, mi_cols=enc.grid.cols,
                mf=save_motion_field(enc.grid, _side, enc.grid.rows,
                                     enc.grid.cols))
        # decoder-side RefOrderHint mirror (shown keyframes refresh all)
        for s in range(8):
            if (fp.refresh_frame_flags >> s) & 1:
                self._dpb_hints[s] = order_hint
                self._dpb_mf[s] = mf_entry
        recon = None
        if cfg.recon_enabled or cfg.stat_report:
            if up_final is not None:
                recon = tuple(up_final[p] if p < len(up_final) else None
                              for p in range(1 if self._seq.monochrome else 3))
            else:
                recon = tuple(enc.recon_plane(p)
                              for p in range(1 if self._seq.monochrome else 3))
            self._recon_last = recon
        stats = None
        if cfg.stat_report:
            from svt_av1_psy_tpu.codec.metrics import frame_stats

            if up_final is not None:
                srcs = ((y_full,) if self._seq.monochrome
                        else (y_full, u_full, v_full))
            else:
                srcs = (y,) if self._seq.monochrome else (y, u, v)
            with _stage("host:stats"):
                stats = frame_stats(srcs, recon, cfg.input_depth)
        shown = is_key or gop is None or bool(gop.get("show", True))
        self._packets.append(Packet(payload, pts if pts is not None else self._frame_count,
                                    recon=recon if (cfg.recon_enabled and shown) else None,
                                    stats=stats))
        self._last_qindex = qindex
        if self._rc is not None:
            self._rc.update(is_key, qindex, len(payload))
        if cfg.max_bit_rate and self._rc is None:
            # capped CRF (--mbr): leaky-bucket feedback at the max rate.
            # Bits beyond the tolerated per-frame allowance fill the
            # bucket; the fill maps to a qindex penalty on later frames
            # (rc_process.c capped_crf virtual-buffer regulation).
            fps = cfg.fps_num / max(cfg.fps_denom, 1)
            bpf_max = cfg.max_bit_rate / max(fps, 1e-6)
            allow = bpf_max * (1.0 + cfg.mbr_overshoot_pct / 100.0)
            cap = cfg.max_bit_rate * 2.0    # 2-second bucket
            fill = max(0.0, getattr(self, "_mbr_fill", 0.0)
                       + len(payload) * 8 - allow)
            self._mbr_fill = min(fill, cap)
            self._mbr_qadj = int(round(48.0 * self._mbr_fill / cap))
        self._spent_bits += len(payload) * 8
        self._frames_since_key = 1 if is_key else self._frames_since_key + 1
        self._frame_count += 1
        return ref_planes, recon

    def get_packet(self) -> Optional[Packet]:
        return self._packets.popleft() if self._packets else None

    def get_recon(self):
        """svt_av1_get_recon analog (requires recon_enabled)."""
        if not self.config.recon_enabled:
            raise SvtAv1Error(ErrorCode.ERROR_BAD_PARAMETER, "recon not enabled")
        return self._recon_last

    def encode_avif(self, y, u=None, v=None) -> bytes:
        """One-shot AVIF still encode (the reference's --avif mode)."""
        from svt_av1_psy_tpu.io.avif import write_avif

        self._check_init()
        self.send_picture(y, u, v)
        pkt = self.get_packet()
        seq = self.stream_header()
        return write_avif(
            pkt.data,
            self.config.width,
            self.config.height,
            seq,
            bit_depth=self.config.input_depth,
            monochrome=self._seq.monochrome,
        )

    def deinit(self):
        self._initialized = False
        self._packets.clear()

    def _check_init(self):
        if not self._initialized:
            raise SvtAv1Error(ErrorCode.ERROR_INVALID_COMPONENT, "encoder not initialized")
