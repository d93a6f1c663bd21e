"""Operations and bytes of TTS serving, from shapes and the configuration's
widths: the model flops of one served row, and the work of the decode and
vocoder kernels of one pipeline call.

Flops count 2 per multiply-add of every matrix product and convolution,
transposed convolutions at their nonzero taps (2 x Cin x Cout x K per
input sample), depthwise filters included, and nothing else (no
elementwise work), as torch.utils.flop_counter.FlopCounterMode counts
them. The PLM's attention is counted over all T x T scores, as its
teacher-forced forward computes them.

The kernels' bounds follow the port's table of kernels (PERF.md): a
launch's least time is max(bytes / HBM bandwidth, conv flops x passes /
conv rate + other flops / float32 rate), each input byte read once and
each output byte written once; the AA-snake costs 58 float32 flops per
element (x2 polyphase up, the snake on two samples, the 12-tap down).
"""
from __future__ import annotations

from portbench.harness.peaks import PEAKS

SNAKE_FLOPS = 58


def _conv(t_out, cin, cout, k):
    return 2 * t_out * cin * cout * k


def _convt(t_in, cin, cout, k):
    return 2 * t_in * cin * cout * k


def _aa(length, c):
    """The AA-snake's two depthwise filters: the x2 transposed one over the
    replicate-padded input, the stride-2 one over the output."""
    return _convt(length + 10, c, 1, 12) + _conv(length, c, 1, 12)


def _amp(length, c, k, dils):
    return sum(_conv(length, c, c, k) * 2 + 2 * _aa(length, c) for _ in dils)


def _resblock1(length, c, k, dils):
    return sum(_conv(length, c, c, k) * 2 for _ in dils)


def _encoder(length, h, filt, layers, k, window=True):
    per = 4 * _conv(length, h, h, 1) + 2 * 2 * length * length * h
    if window:
        per += 2 * 2 * length * (2 * length - 1) * h
    per += _conv(length, h, filt, k) + _conv(length, filt, h, k)
    return layers * per


def _style(frames, n_mels, hidden, out):
    return (_conv(frames, n_mels, hidden, 1) + _conv(frames, hidden, hidden, 1)
            + 2 * _conv(frames, hidden, 2 * hidden, 5)
            + 4 * _conv(frames, hidden, hidden, 1) + 2 * 2 * frames * frames * hidden
            + _conv(frames, hidden, out, 1))


def _lstm(steps, cin, hidden, layers):
    total = 0
    for layer in range(layers):
        n_in = cin if layer == 0 else 2 * hidden
        total += 2 * (2 * steps * n_in * 4 * hidden + steps * 2 * hidden * 4 * hidden)
    return total


def _wn(length, h, k, layers, gin):
    return (2 * gin * 2 * h * layers + layers * _conv(length, h, 2 * h, k)
            + (layers - 1) * _conv(length, h, 2 * h, 1) + _conv(length, h, h, 1))


def ttv_flops(c, n, prompt_frames, frames):
    """TTV at its own lengths: n phones, the padded prompt's mel frames,
    `frames` 50 Hz frames (the Gaussian upsampler at 2 x frames)."""
    h, gin, f = c["inter_channels"], c["gin_channels"], c["filter_channels"]
    p, k = prompt_frames, c["kernel_size"]
    total = _style(p, c["n_mels"], c["style_hidden"], gin)
    total += _encoder(n, h, f, c["text_layers"] + 1, k)
    total += _encoder(p, c["n_mels"], c["mel_filter_channels"], c["mel_enc_layers"], k)
    total += _conv(p, c["n_mels"], h, 1)
    total += 2 * _conv(n, h, h, 1) + 2 * _conv(p, h, h, 1) + 2 * 2 * n * p * h
    total += 2 * gin * h                                     # cond_g
    total += 2 * gin * h + _lstm(n, h, c["duration_filter"], 2)
    total += _conv(n, 2 * c["duration_filter"], 1, 1)
    total += _lstm(n, h + 1, c["range_channels"], 1) + _conv(n, 2 * c["range_channels"], 1, 1)
    total += 2 * (2 * frames) * n * h                        # Gaussian upsampling
    total += _conv(frames, h, c["hidden_channels"], 1)       # dur_downsample
    total += _conv(frames, c["prosody_size"], h, 1)          # ssl_proj
    total += 2 * gin * h + _encoder(frames, h, f, c["w2v_enc_layers"] + 1, k)
    dh, w2v = c["w2v_dec_hidden"], c["w2v_dim"]
    total += (_conv(frames, h, dh, 1) + _wn(frames, dh, c["w2v_dec_kernel"],
                                            c["w2v_dec_layers"], gin)
              + _conv(frames, dh, w2v, 1))
    pc = c["pitch_channels"]
    total += _conv(frames, w2v, pc, 7) + 2 * gin * pc
    length, ch = frames, pc
    for _ in range(2):
        total += _convt(length, ch, ch // 2, 4)
        length, ch = 2 * length, ch // 2
        total += sum(_resblock1(length, ch, kk, (1, 3, 5)) for kk in (3, 5, 7))
    return total + _conv(length, ch, 1, 7)


def plm_flops(c, frames):
    d = c["vq_dim"] + c["tc_latent_dim"]
    ff = c["ff_mult"] * d
    per = (4 * _conv(frames, d, d, 1) + 2 * 2 * frames * frames * d
           + _conv(frames, d, ff, 1) + _conv(frames, ff, d, 1))
    return c["n_layers"] * per + _conv(frames, d, c["vq_bins"], 1)


def _flow(c, frames):
    h, ic, gin = c["hidden_channels"], c["inter_channels"], c["gin_channels"]
    block = (2 * h * 6 * h + _conv(frames, h, 3 * h, 1) + 2 * 2 * frames * frames * h
             + _conv(frames, h, h, 1) + _conv(frames, h, 4 * h, 5)
             + _conv(frames, 4 * h, h, 1))
    coupling = (_conv(frames, ic // 2, h, 1) + c["flow_layers"] * block
                + _conv(frames, h, ic // 2, 1))
    return 2 * gin * 4 * h + 2 * 4 * h * h + c["n_flows"] * coupling


def vocoder_flops(c, frames, prompt_true_frames):
    """The vocoder at `frames` 50 Hz frames, its style from the prompt's
    true-length mel."""
    ic, h, gin, uic = (c["inter_channels"], c["hidden_channels"],
                       c["gin_channels"], c["upsample_initial_channel"])
    total = _style(prompt_true_frames, c["n_mels"], c["style_hidden"], gin)
    half = c["posterior_wn_layers"] // 2
    total += _conv(frames, c["w2v_dim"], h, 1) + _conv(frames, 1, h, 9)
    total += 3 * _wn(frames, h, 5, half, gin) + _conv(frames, h, 2 * ic, 1)
    total += 2 * _flow(c, frames)
    # source network
    sc = uic // 2
    total += _conv(frames, ic, sc, 7) + 2 * gin * sc
    length, ch = frames, sc
    for _ in range(2):
        total += _convt(length, ch, ch // 2, 4)
        length, ch = 2 * length, ch // 2
        total += sum(_amp(length, ch, kk, (1, 3, 5)) for kk in (3, 5, 7))
    total += _aa(length, ch)
    # generator
    pitch = uic // 8
    total += _conv(frames, ic, uic, 7)
    total += (_conv(4 * frames, pitch, uic, 1) + _conv(frames, pitch, uic, 3)
              + 2 * _conv(frames, uic, uic, 3))
    total += 2 * gin * uic + _conv(4 * frames, pitch, uic // 2, 7)
    length, ch = frames, uic
    for u, k in zip(c["upsample_rates"], c["upsample_kernel_sizes"]):
        total += _convt(length, ch, ch // 2, k)
        length, ch = length * u, ch // 2
        total += sum(_amp(length, ch, kk, d) for kk, d in
                     zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]))
    return total + _aa(length, ch) + _conv(length, ch, 1, 7)


def speechsr_flops(c, samples16):
    ch = c["upsample_initial_channel"]
    n = samples16 * c["rate_num"] // c["rate_den"]
    return (_conv(samples16, 1, ch, 7)
            + sum(_amp(n, ch, k, d) for k, d in zip(c["resblock_kernel_sizes"],
                                                   c["resblock_dilation_sizes"]))
            + _aa(n, ch) + _conv(n, ch, 1, 7))


def row_flops(cfg, n, prompt_frames, prompt_true_frames, frames):
    """Model flops one served row needs at its own lengths."""
    return (ttv_flops(cfg["ttv"], n, prompt_frames, frames)
            + plm_flops(cfg["plm"], frames)
            + vocoder_flops(cfg["vocoder"], frames, prompt_true_frames)
            + speechsr_flops(cfg["speechsr"], 320 * frames))


# ---------------- kernel work of one pipeline call ----------------


def decode_work(c, rows, t):
    """The greedy decode of `rows` rows of t positions each (bf16 weights
    and cache): (matrix flops, attention flops, bytes), the weights read
    once a call, the latent read and the codes written per row."""
    d = c["vq_dim"] + c["tc_latent_dim"]
    ff, layers, bins = c["ff_mult"] * d, c["n_layers"], c["vq_bins"]
    matrix = rows * t * (layers * 2 * (4 * d * d + 2 * d * ff) + 2 * d * bins)
    attn = rows * layers * 2 * d * t * (t + 1)
    weights = 2 * (layers * (4 * d * d + 2 * d * ff) + d * bins)
    return matrix, attn, weights + rows * t * (4 * c["tc_latent_dim"] + 4)


def decode_bound_s(c, rows, t):
    matrix, attn, nbytes = decode_work(c, rows, t)
    return max(nbytes / PEAKS["hbm_bytes_s"],
               matrix / PEAKS["bf16_flops_s"] + attn / PEAKS["fp32_flops_s"])


def _block_launches(b, t, c, k, dils, x_bytes, out_bytes, w_bytes):
    """The 6 snake-conv launches of one AMP block: each reads its input
    (and the residual), writes its output; intermediates float32."""
    out, x = [], x_bytes
    for i, _ in enumerate(dils):
        last = i == len(dils) - 1
        conv = 2 * b * t * c * c * k
        other = SNAKE_FLOPS * b * t * c
        out.append((conv, other, b * t * c * (x + 4) + k * c * c * w_bytes))
        y = out_bytes if last else 4
        out.append((conv, other, b * t * c * (4 + x + y) + k * c * c * w_bytes))
        x = 4
    return out


def vocoder_launches(cfg, b, frames, bf16: bool):
    """(conv flops, other flops, bytes) of every launch of the vocoder and
    SpeechSR kernels in one call of b rows at `frames` 50 Hz frames."""
    v, s = cfg["vocoder"], cfg["speechsr"]
    act = 2 if bf16 else 4
    wb = 2 if bf16 else 4
    launches = []

    def aa(t, c):
        launches.append((0, SNAKE_FLOPS * b * t * c, 2 * b * t * c * act))

    def ampblock(t, c, ks, dils):
        for k, d in zip(ks, dils):
            launches.extend(_block_launches(b, t, c, k, d, act, act, wb))

    def triple(t, c, ks, dils, tail):
        for k, d in zip(ks, dils):
            launches.extend(_block_launches(b, t, c, k, d, act, 4, wb))
        if tail:
            launches.append((0, b * t * c * (3 + SNAKE_FLOPS + 14), b * t * (12 * c + act)))
        else:
            launches.append((0, 3 * b * t * c, b * t * c * (12 + act)))

    uic = v["upsample_initial_channel"]
    ks, dils = v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]
    # source network: C = uic/4 at 2T (AMP), uic/8 at 4T (stage), its AA-snake
    ampblock(2 * frames, uic // 4, (3, 5, 7), [(1, 3, 5)] * 3)
    triple(4 * frames, uic // 8, (3, 5, 7), [(1, 3, 5)] * 3, False)
    aa(4 * frames, uic // 8)
    length, ch = frames, uic
    last = len(v["upsample_rates"]) - 1
    for i, u in enumerate(v["upsample_rates"]):
        length, ch = length * u, ch // 2
        if ch > 128:
            for _ in range(6 * len(ks)):
                aa(length, ch)
        elif ch > 64:
            ampblock(length, ch, ks, dils)
        else:
            triple(length, ch, ks, dils, i == last)
    n = length * s["rate_num"] // s["rate_den"]
    triple(n, s["upsample_initial_channel"], s["resblock_kernel_sizes"],
           s["resblock_dilation_sizes"], True)
    return launches


def launch_bound_s(launch, bf16: bool):
    conv, other, nbytes = launch
    conv_s = (conv / PEAKS["bf16_flops_s"] if bf16
              else 3 * conv / PEAKS["tf32_flops_s"])
    return max(nbytes / PEAKS["hbm_bytes_s"], conv_s + other / PEAKS["fp32_flops_s"])
