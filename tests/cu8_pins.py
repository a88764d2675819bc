"""The uniform 8x8 grid (cu_size=8, a CTU of 8): test clips, sessions and
the JAX package's pins over them, shared by tests/test_torch_cu8.py and
chip_smoke.py (this module imports neither JAX nor the JAX package).

SESSIONS holds, for each session, its clip, its mode ("ippp":
encode_frame, "push": push_frame / flush, "intra": the all-intra
session's encode_frame, "batch": one encode_batch of the whole clip) and
its keywords; PINS the md5 of the JAX package's stream of it and each
result's (POC, type, QP) in coding order. REFUSED holds the options the
JAX session fails on at cu 8, with the exception it raises. All pins were
computed from the JAX package at commit e5e1e58 on the CPU; the slow
tests of tests/test_torch_cu8.py recompute them."""
import hashlib
import os

import numpy as np

import golden_corpus
import main10_pins
import parallel_pins
import stream_opts_pins

W, H = 64, 48


def clip(n: int = 4, w: int = W, h: int = H):
    """The golden clip's first n frames (a gradient with a texture moving
    3 pixels right and 2 down a frame)."""
    return golden_corpus.clip(w, h, n=n)


UNI8 = dict(qp=32, cu_size=8, keyint=100, hash_sei=True)
INTRA8 = dict(qp=30, cu_size=8, hash_sei=True)

# name: (clip, mode, keywords with width and height). psy_rd, hme, rqt,
# search_range 24 and the histogram cut change nothing on the uniform
# grid: their streams equal "plain"'s.
SESSIONS = {
    # parallel_pins.CU8_MD5's session
    "base": (lambda: parallel_pins.session_clip(W, H, 3), "ippp",
             dict(width=W, height=H, qp=32, cu_size=8, keyint=10)),
    "plain": (clip, "ippp", dict(width=W, height=H, **UNI8)),
    # a size that pads (100x60 codes 104x64)
    "pad_100x60": (lambda: clip(3, 100, 60), "ippp",
                   dict(width=100, height=60, **UNI8)),
    # the in-loop filters (the deblock's P / B chroma edges: ROADMAP
    # Queue 3), SBH, RDOQ
    "deblock": (clip, "ippp", dict(width=W, height=H, deblock=True, **UNI8)),
    "sao": (clip, "ippp", dict(width=W, height=H, sao=True, **UNI8)),
    "deblock_sao": (clip, "ippp", dict(width=W, height=H, deblock=True,
                                       sao=True, **UNI8)),
    "sbh": (clip, "ippp", dict(width=W, height=H, sbh=True, **UNI8)),
    "rdoq": (clip, "ippp", dict(width=W, height=H, rdoq=True, **UNI8)),
    "psy_rdoq": (clip, "ippp", dict(width=W, height=H, rdoq=True,
                                    psy_rdoq=1.0, **UNI8)),
    # cuTree: the causal average pools no lowres block at cu 8 (all
    # offsets 0); the rc-lookahead window pools one a CU
    "cutree": (clip, "ippp", dict(width=W, height=H, cutree=True, **UNI8)),
    "cutree_la": (lambda: clip(5), "la", dict(width=W, height=H, cutree=True,
                                             rc_lookahead=3, **UNI8)),
    # rate control
    "crf": (clip, "ippp", dict(width=W, height=H, rc_mode="crf", crf=28.0,
                               **UNI8)),
    "abr_vbv": (clip, "ippp", dict(width=W, height=H, rc_mode="abr",
                                   bitrate_kbps=100, vbv_maxrate_kbps=150,
                                   vbv_bufsize_kbps=300, **UNI8)),
    "hrd": (clip, "ippp", dict(width=W, height=H, rc_mode="abr",
                               bitrate_kbps=100, vbv_maxrate_kbps=150,
                               vbv_bufsize_kbps=300, hrd=True, **UNI8)),
    "zones": (clip, "ippp", dict(width=W, height=H, zones="1,2,q=26",
                                 **UNI8)),
    "scenecut_qp": (clip, "ippp", dict(width=W, height=H,
                                       scenecut_aware_qp=True, **UNI8)),
    # B frames: b-adapt 2 (the default), 0 and 1; with the filters,
    # weightp, cuTree, 10 bits, RDOQ + SBH, CRF; b_intra (the quadtree's
    # option: the same stream); open GOP
    "bframes3": (lambda: clip(6), "push", dict(width=W, height=H, bframes=3,
                                               **UNI8)),
    "bframes3_badapt0": (lambda: clip(6), "push",
                         dict(width=W, height=H, bframes=3, b_adapt=0,
                              **UNI8)),
    "b_adapt1": (lambda: clip(6), "push", dict(width=W, height=H, bframes=3,
                                               b_adapt=1, **UNI8)),
    "b_lf": (lambda: clip(6), "push", dict(width=W, height=H, bframes=3,
                                           deblock=True, sao=True, **UNI8)),
    "b_weightp": (lambda: stream_opts_pins.fade(clip(6)), "push",
                  dict(width=W, height=H, bframes=3, weightp=True, **UNI8)),
    "b_cutree": (lambda: clip(6), "push", dict(width=W, height=H, bframes=3,
                                               cutree=True, **UNI8)),
    "b_main10": (lambda: main10_pins.deep(clip(5), 10), "push",
                 dict(width=W, height=H, bframes=3, bit_depth=10, **UNI8)),
    "b_rdoq_sbh": (lambda: clip(5), "push",
                   dict(width=W, height=H, bframes=2, rdoq=True, sbh=True,
                        **UNI8)),
    "b_crf": (lambda: clip(5), "push",
              dict(width=W, height=H, bframes=2, rc_mode="crf", **UNI8)),
    "b_intra": (lambda: clip(6), "push", dict(width=W, height=H, bframes=3,
                                              b_intra=True, **UNI8)),
    "open_gop": (lambda: clip(7), "push",
                 dict(width=W, height=H, bframes=3, open_gop=True,
                      **dict(UNI8, keyint=4))),
    # the P-frame options (TMVP at cu 8: ROADMAP Queue 3), WPP, frame
    # duplication
    "weightp": (lambda: stream_opts_pins.fade(clip()), "ippp",
                dict(width=W, height=H, weightp=True, **UNI8)),
    "ref2": (clip, "ippp", dict(width=W, height=H, n_refs=2, **UNI8)),
    "tmvp": (clip, "ippp", dict(width=W, height=H, tmvp=True, **UNI8)),
    "ref2_tmvp_lf": (clip, "ippp", dict(width=W, height=H, n_refs=2,
                                        tmvp=True, deblock=True, sao=True,
                                        **UNI8)),
    "merge1": (clip, "ippp", dict(width=W, height=H, max_merge=1, **UNI8)),
    "merge5": (clip, "ippp", dict(width=W, height=H, max_merge=5, **UNI8)),
    "wpp": (clip, "ippp", dict(width=W, height=H, wpp=True, **UNI8)),
    "wpp_b": (lambda: clip(6), "push", dict(width=W, height=H, wpp=True,
                                            bframes=3, **UNI8)),
    "frame_dup": (lambda: [clip(1)[0]] * 3, "ippp",
                  dict(width=W, height=H, frame_dup=True, **UNI8)),
    # 10 and 12 bits, the hashes, the options that change nothing here
    "main10": (lambda: main10_pins.deep(clip(3), 10), "ippp",
               dict(width=W, height=H, bit_depth=10, **UNI8)),
    "main10_lf": (lambda: main10_pins.deep(clip(3), 10), "ippp",
                  dict(width=W, height=H, bit_depth=10, deblock=True,
                       sao=True, **UNI8)),
    "main12": (lambda: main10_pins.deep(clip(3), 12), "ippp",
               dict(width=W, height=H, bit_depth=12, **UNI8)),
    "hash1": (clip, "ippp", dict(width=W, height=H, hash_type=1, **UNI8)),
    "hash2": (clip, "ippp", dict(width=W, height=H, hash_type=2, **UNI8)),
    "psy_rd": (clip, "ippp", dict(width=W, height=H, psy_rd=1.0, **UNI8)),
    "hme": (clip, "ippp", dict(width=W, height=H, hme=True, **UNI8)),
    "rqt": (clip, "ippp", dict(width=W, height=H, rqt=True, **UNI8)),
    "sr24": (clip, "ippp", dict(width=W, height=H, search_range=24, **UNI8)),
    "hist_scenecut": (clip, "ippp", dict(width=W, height=H,
                                         hist_scenecut=True, **UNI8)),
    # the all-intra session
    "intra": (lambda: clip(2), "intra", dict(width=W, height=H, **INTRA8)),
    "intra_pad": (lambda: clip(1, 100, 60), "intra",
                  dict(width=100, height=60, deblock=True, sao=True,
                       **INTRA8)),
    "intra_lf": (lambda: clip(1), "intra",
                 dict(width=W, height=H, deblock=True, sao=True, **INTRA8)),
    "intra_rdoq_sbh": (lambda: clip(1), "intra",
                       dict(width=W, height=H, sbh=True, rdoq=True,
                            psy_rdoq=1.0, **INTRA8)),
    "intra_lossless": (lambda: clip(1), "intra",
                       dict(width=W, height=H, lossless=True, **INTRA8)),
    "intra_slices": (lambda: clip(1), "intra",
                     dict(width=W, height=H, slices=2, **INTRA8)),
    "intra_wpp": (lambda: clip(1), "intra",
                  dict(width=W, height=H, wpp=True, **INTRA8)),
    "intra_scaling": (lambda: clip(1), "intra",
                      dict(width=W, height=H, scaling_lists="default",
                           **INTRA8)),
    "intra_i444": (lambda: [(y, np.repeat(np.repeat(u, 2, 0), 2, 1),
                             np.repeat(np.repeat(v, 2, 0), 2, 1))
                            for y, u, v in clip(1)], "intra",
                   dict(width=W, height=H, csp="i444", **INTRA8)),
    "intra_nr": (lambda: clip(3), "intra",
                 dict(width=W, height=H, nr_intra=1000, **INTRA8)),
    "intra_fast": (lambda: clip(1), "intra",
                   dict(width=W, height=H, fast_intra=True, **INTRA8)),
    "intra_main10": (lambda: main10_pins.deep(clip(1), 10), "intra",
                     dict(width=W, height=H, bit_depth=10, **INTRA8)),
    "intra_hash1": (lambda: clip(1), "intra",
                    dict(width=W, height=H, hash_type=1, **INTRA8)),
    "intra_batch": (lambda: clip(3), "batch",
                    dict(width=W, height=H, **INTRA8)),
    "intra_batch_lf": (lambda: clip(3), "batch",
                       dict(width=W, height=H, deblock=True, sao=True,
                            **INTRA8)),
    # a batch ignores AQ (ROADMAP Queue 3), so it codes where a single
    # frame fails
    "intra_batch_aq": (lambda: clip(2), "batch",
                       dict(width=W, height=H, aq_mode=2, **INTRA8)),
}

# AQ at cu 8: the offsets come on the 16x16 grid, a quarter of the CUs,
# and the reference fails on the shapes at the first frame (ValueError)
REFUSED = {
    "aq1": (clip, "ippp", dict(width=W, height=H, aq_mode=1, **UNI8)),
    "aq2": (clip, "ippp", dict(width=W, height=H, aq_mode=2, **UNI8)),
    "aq3": (clip, "ippp", dict(width=W, height=H, aq_mode=3, **UNI8)),
    "aq4": (clip, "ippp", dict(width=W, height=H, aq_mode=4, **UNI8)),
    "aq2_cutree": (clip, "ippp", dict(width=W, height=H, aq_mode=2,
                                      cutree=True, **UNI8)),
    "b_aq2": (lambda: clip(6), "push", dict(width=W, height=H, bframes=3,
                                            aq_mode=2, **UNI8)),
    "intra_aq": (lambda: clip(1), "intra",
                 dict(width=W, height=H, aq_mode=2, **INTRA8)),
    "intra_lf_aq": (lambda: clip(1), "intra",
                    dict(width=W, height=H, deblock=True, sao=True,
                         aq_mode=2, sbh=True, rdoq=True, **INTRA8)),
}

PINS = {'base': ('8ea7d1716a9cfc8cc3c56272ca6ca669',
          [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32)]),
 'plain': ('ad618022792d8b59f6a16f171d7b66a2',
           [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'pad_100x60': ('aefdafa5e64514d0df5d889475e90f17',
                [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32)]),
 'deblock': ('3ad45167fd8a271a93d01b24afa7f5e1',
             [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'sao': ('a4f6c3acdb1117b51377dcc14a43025b',
         [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'deblock_sao': ('6c52eb80cf0af2d1fcca6fdf49f3df2c',
                 [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'sbh': ('a16229de3fbd3524348e0661696e7cd3',
         [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'rdoq': ('9dba968d3d57019deab6b50297a403d5',
          [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'psy_rdoq': ('f99dad7e83fb4d1e22e7569dbfe4f7fc',
              [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'cutree': ('dc031e2feefa40d67a7a6cb78c2f2d1f',
            [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'cutree_la': ('b0bc9beae28b31971904182373f9e352',
               [(0, 'I', 29),
                (1, 'P', 32),
                (2, 'P', 32),
                (3, 'P', 32),
                (4, 'P', 32)]),
 'crf': ('4c774d67e333b34c8d558cd2f4f8dac5',
         [(0, 'I', 32), (1, 'P', 34), (2, 'P', 33), (3, 'P', 33)]),
 'abr_vbv': ('5fcaa8e6fd03bbad6e18a7c0c6495dd0',
             [(0, 'I', 36), (1, 'P', 32), (2, 'P', 25), (3, 'P', 28)]),
 'hrd': ('0d12d350edc1e1ebd04e6157b5a0c145',
         [(0, 'I', 36), (1, 'P', 32), (2, 'P', 25), (3, 'P', 29)]),
 'zones': ('26adfeefd5aa5e28992e56b64e38b0d0',
           [(0, 'I', 29), (1, 'P', 26), (2, 'P', 26), (3, 'P', 32)]),
 'scenecut_qp': ('2c443d3e83937ebfd9d2a843ff9dc512',
                 [(0, 'I', 34), (1, 'P', 37), (2, 'P', 37), (3, 'P', 37)]),
 'bframes3': ('15272b05d8818bc6a17d28878de550ea',
              [(0, 'I', 29),
               (3, 'P', 32),
               (2, 'B', 33),
               (1, 'b', 34),
               (5, 'P', 32),
               (4, 'b', 34)]),
 'bframes3_badapt0': ('93e265110ad6cf7a18c645c95e7e120b',
                      [(0, 'I', 29),
                       (4, 'P', 32),
                       (2, 'B', 33),
                       (1, 'b', 34),
                       (3, 'b', 34),
                       (5, 'P', 32)]),
 'b_adapt1': ('93e265110ad6cf7a18c645c95e7e120b',
              [(0, 'I', 29),
               (4, 'P', 32),
               (2, 'B', 33),
               (1, 'b', 34),
               (3, 'b', 34),
               (5, 'P', 32)]),
 'b_lf': ('892f121c5a9fc7b93175ca394bc6c3d1',
          [(0, 'I', 29),
           (3, 'P', 32),
           (2, 'B', 33),
           (1, 'b', 34),
           (5, 'P', 32),
           (4, 'b', 34)]),
 'b_weightp': ('894a22cf67b13db575867ad1ebb40fd5',
               [(0, 'I', 29),
                (3, 'P', 32),
                (2, 'B', 33),
                (1, 'b', 34),
                (5, 'P', 32),
                (4, 'b', 34)]),
 'b_cutree': ('5ebb6c2f26b0368f39de28f91ea81cf6',
              [(0, 'I', 29),
               (3, 'P', 32),
               (2, 'B', 33),
               (1, 'b', 34),
               (5, 'P', 32),
               (4, 'b', 34)]),
 'b_main10': ('05b3f165943d731a7e4b734344b31824',
              [(0, 'I', 29),
               (3, 'P', 32),
               (2, 'B', 33),
               (1, 'b', 34),
               (4, 'P', 32)]),
 'b_rdoq_sbh': ('0832c73b12ceb3e9a928a3084fba570f',
                [(0, 'I', 29),
                 (3, 'P', 32),
                 (2, 'B', 33),
                 (1, 'b', 34),
                 (4, 'P', 32)]),
 'b_crf': ('b2abdcdb662a1c8a6a115a8ea72897df',
           [(0, 'I', 25),
            (3, 'P', 35),
            (2, 'B', 39),
            (1, 'b', 40),
            (4, 'P', 37)]),
 'b_intra': ('15272b05d8818bc6a17d28878de550ea',
             [(0, 'I', 29),
              (3, 'P', 32),
              (2, 'B', 33),
              (1, 'b', 34),
              (5, 'P', 32),
              (4, 'b', 34)]),
 'open_gop': ('29a63040a9eb68e7671f8332430ba434',
              [(0, 'I', 29),
               (4, 'I', 29),
               (1, 'b', 34),
               (2, 'b', 34),
               (3, 'b', 34),
               (6, 'P', 32),
               (5, 'b', 34)]),
 'weightp': ('c5bef67043775c6ac976244c8c73986e',
             [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'ref2': ('58a9b5b691111562b52e77b7cc0d9012',
          [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'tmvp': ('5ac2d51ed7962550f3d21fbb09c3d24b',
          [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'ref2_tmvp_lf': ('b2ca585778c042406353f6282f4d0c16',
                  [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'merge1': ('d325f10b76a403e4d2811c4ccc86fcea',
            [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'merge5': ('4ae2faaf66ba18dbae7dd4803f103b13',
            [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'wpp': ('3b24eb270d62c6142790fa06b3b39a10',
         [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'wpp_b': ('bbfbf824be936fe7448593d2248c3d6b',
           [(0, 'I', 29),
            (3, 'P', 32),
            (2, 'B', 33),
            (1, 'b', 34),
            (5, 'P', 32),
            (4, 'b', 34)]),
 'frame_dup': ('06af4ba3a85824f771faa6094acf158c',
               [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32)]),
 'main10': ('caa6a3ab6cd32867aca203b51be62fad',
            [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32)]),
 'main10_lf': ('c15cd751eae59c4719e27a33bcb50d41',
               [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32)]),
 'main12': ('523dc921508a328170457322f0a9a4ab',
            [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32)]),
 'hash1': ('617189f2656001dc0528778f51809199',
           [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'hash2': ('b8c7429df99cfacb25b0fa2f290d4c1b',
           [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'psy_rd': ('ad618022792d8b59f6a16f171d7b66a2',
            [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'hme': ('ad618022792d8b59f6a16f171d7b66a2',
         [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'rqt': ('ad618022792d8b59f6a16f171d7b66a2',
         [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'sr24': ('ad618022792d8b59f6a16f171d7b66a2',
          [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'hist_scenecut': ('ad618022792d8b59f6a16f171d7b66a2',
                   [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
 'intra': ('1feb945c3085cd49769182bab5062fce', [(0, 'I', 30), (0, 'I', 30)]),
 'intra_pad': ('b577f6a0264ebe4a0b1784f2351b10a1', [(0, 'I', 30)]),
 'intra_lf': ('dc25978c0d6fb56236b3e8384cfffa87', [(0, 'I', 30)]),
 'intra_rdoq_sbh': ('59f371a4b1ff08005d139422af20f603', [(0, 'I', 30)]),
 'intra_lossless': ('aadea54692faff11f877de99a03ec86d', [(0, 'I', 4)]),
 'intra_slices': ('e8bb8e9642945f28c7ef9a6021a9212d', [(0, '', 0)]),
 'intra_wpp': ('08243f569fb6fb61c929bce72cde37e5', [(0, 'I', 30)]),
 'intra_scaling': ('1edcf341a5fd0fe743c8f28f5dcbef56', [(0, 'I', 30)]),
 'intra_i444': ('c6565a7f2952000af10378ceaa3715bf', [(0, 'I', 30)]),
 'intra_nr': ('529fda5cfe12437ca40553f1165d46db',
              [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30)]),
 'intra_fast': ('4e992c1f84a51f13208ecf4610edaaa7', [(0, 'I', 30)]),
 'intra_main10': ('b1ef21898ff0df82c89442d9b29e737d', [(0, 'I', 30)]),
 'intra_hash1': ('4ba46359efb295ab942c91506e860324', [(0, 'I', 30)]),
 'intra_batch': ('7463a14c412e1d470b0a61c636a5b01c',
                 [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30)]),
 'intra_batch_lf': ('a10bade4a91f3bb1c7e757f2b2382b24',
                    [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30)]),
 'intra_batch_aq': ('aa514f85210f58ffd0043a25e099c39c',
                    [(0, 'I', 30), (0, 'I', 30)])}


def md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def run(top, name: str, **kw):
    """The session `name` of the encoder_top module `top` (the port's or
    the JAX package's) over its clip: (stream md5, [(POC, type, QP)] in
    coding order, the stream, the results). kw goes to the session (the
    port's device)."""
    clip_fn, mode, opts = {**SESSIONS, **REFUSED}[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    intra = mode in ("intra", "batch")
    s = (top.IntraEncoderSession if intra else top.VideoEncoderSession)(
        w, h, **opts, **kw)
    frames, res = clip_fn(), []
    if mode == "batch":
        res = s.encode_batch(frames)
    else:
        for f in frames:
            res += (s.push_frame(*f) if mode == "push" else
                    s.push_la(*f) if mode == "la" else [s.encode_frame(*f)])
        if mode == "push":
            res += s.flush()
        elif mode == "la":
            res += s.flush_la()
    stream = s.headers() + b"".join(r.nals for r in res)
    out, poc = [], 0
    for r in res:
        if mode == "push":
            poc = r.poc
        elif intra:
            poc = 0
        else:
            poc = 0 if r.frame_type == "I" else poc + 1
        out.append((poc, r.frame_type, r.qp))
    return md5(stream), out, stream, res


# ---------------------------------------------------------------------------
# PipelinedEncoder(cu_size=8), analysis save / load, two passes
# ---------------------------------------------------------------------------

PIPE_FRAMES = 6
# run_pipeline's (stream md5, QPs); encode_clip and encode_clip_sequential
# code the same stream
PIPE_PIN = ("3d8513105e4e3a2d48f32d2af053d3b0", [32] * PIPE_FRAMES)


def run_pipeline(pipelined_encoder, sequential: bool = False, **kw):
    """PipelinedEncoder(64, 48, qp=32, cu_size=8, n_devices=4) over
    parallel_pins.session_clip(64, 48, PIPE_FRAMES) (kw: the port's device
    / devices): (stream md5, each frame's QP)."""
    enc = pipelined_encoder(W, H, qp=32, cu_size=8, n_devices=4, **kw)
    frames = parallel_pins.session_clip(W, H, PIPE_FRAMES)
    res = (enc.encode_clip_sequential if sequential
           else enc.encode_clip)(frames)
    return (md5(enc.headers() + b"".join(r.nals for r in res)),
            [int(r.qp) for r in res])


def file_md5(path: str) -> str:
    with open(path, "rb") as f:
        return md5(f.read())


def run_two_files(top, workdir: str, kind: str, **kw):
    """Two sessions at cu 8 through a file in workdir: kind "analysis"
    (analysis_save, then analysis_load, over 4 frames of
    tools_pins.moving_scene) or "two_pass" (stats_write, then stats_read,
    ABR 100 kbps with cuTree over clip()): {"first": pass 1's stream md5,
    "file": the file's md5, "second": pass 2's md5}. kw go to the
    sessions (the port's device)."""
    import tools_pins
    path = os.path.join(workdir, f"{kind}.dat")
    if kind == "analysis":
        frames = tools_pins.moving_scene(W, H, 4)
        opts = dict(qp=32, cu_size=8, keyint=100, hash_sei=False)
        first, second = dict(analysis_save=path), dict(analysis_load=path)
    else:
        frames = clip()
        opts = dict(qp=32, cu_size=8, keyint=100, rc_mode="abr",
                    bitrate_kbps=100, cutree=True)
        first, second = dict(stats_write=path), dict(stats_read=path)
    s1 = top.VideoEncoderSession(W, H, **first, **opts, **kw)
    st1 = s1.headers() + b"".join(s1.encode_frame(*f).nals for f in frames)
    (s1.analysis_save if kind == "analysis" else s1.stats_writer).close()
    s2 = top.VideoEncoderSession(W, H, **second, **opts, **kw)
    st2 = s2.headers() + b"".join(s2.encode_frame(*f).nals for f in frames)
    return {"first": md5(st1), "file": file_md5(path), "second": md5(st2)}


TWO_FILE_PINS = {
    "analysis": {"first": "be1c9a6d668ce4e213911a5f39179dec",
                 "file": "d9a32c5a29ec057b776c15e2103ae284",
                 "second": "a551a1bfbc200a532e50dd633cd71e64"},
    "two_pass": {"first": "62a18e45d61dfb2b08bd9ec72468f641",
                 "file": "1a9cab40dd2ad04d88d0cf1ef7c8e38a",
                 "second": "4049d0a319db82b23d4023f9a1fee49d"}}
