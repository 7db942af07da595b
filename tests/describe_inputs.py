"""K5's inputs with keypoints moved onto every octave's borders, shared by
``tests/bits_report.py``'s ``describe`` case (on the card) and
``tests/test_torch_describe_retrieval_layout.py`` (on the CPU). It imports
nothing: ``torch`` is passed in, as the report's cases take it."""


def describe_border(torch, args, per_octave: int = 24):
    """K5's inputs with the first keypoints of each image moved onto the
    borders of every octave (corners, edges, just outside): the patch's slice
    start clamps there."""
    canvas, gl, x, y, sr, ro, wo, ho = (t.clone() for t in args)
    octaves = sorted({(int(a), int(b), int(c)) for a, b, c in
                      zip(ro[0].tolist(), wo[0].tolist(), ho[0].tolist())})
    k = 0
    for r_off, w, h in octaves:
        xs = (-0.6, 0.0, 0.49, 31.5, w - 33.0, w - 1.0, w - 0.51, w + 2.0)
        ys = (-0.6, 0.0, 32.5, h - 1.0, h - 0.51, h + 2.0)
        spots = [(a, b) for a in xs for b in ys][::2][:per_octave] + [(w / 2.0, h / 2.0)]
        for a, b in spots:
            if k >= x.shape[1]:
                break
            x[:, k], y[:, k], ro[:, k], wo[:, k], ho[:, k] = a, b, r_off, w, h
            sr[:, k], gl[:, k] = 1.6 + 0.7 * (k % 3), k % canvas.shape[1]
            k += 1
    return canvas, gl, x, y, sr, ro, wo, ho
