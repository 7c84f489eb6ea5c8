/* fastout — native output-path hot loops for cuburn_tpu.
 *
 * The device renders frames; the host must encode them (PNG stills, YCbCr
 * conversion for the video pipe) at frame rate.  The reference kept
 * its output path in Python/PIL (cuburn/output.py, SURVEY.md layer 5);
 * at 1080p60 the per-frame Python conversion loops become the frame
 * pipeline's host-side bottleneck, so this module implements them in C
 * (CPython C API + zlib; no external deps):
 *
 *   encode_png(rgba_bytes, width, height, compress_level) -> bytes
 *       RGBA8 -> PNG (Paeth-filtered scanlines, zlib deflate)
 *   rgb_to_ycbcr444(rgba_bytes, width, height) -> bytes
 *       RGBA8 -> planar 4:4:4 YCbCr (BT.601 full range), for y4m
 *
 * Python falls back to zlib/numpy when this extension is not built
 * (cuburn_tpu/output.py).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

/* ---------------------------------------------------------------- PNG */

static void put_be32(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);  p[3] = (uint8_t)v;
}

static int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

static PyObject *fastout_encode_png(PyObject *self, PyObject *args) {
    Py_buffer buf;
    Py_ssize_t width, height;
    int level = 6;
    if (!PyArg_ParseTuple(args, "y*nn|i", &buf, &width, &height,
                          &level))
        return NULL;
    if (width <= 0 || height <= 0) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError,
                        "width and height must be positive");
        return NULL;
    }
    const Py_ssize_t stride = width * 4;
    if (buf.len < stride * height) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "buffer too small for WxHx4");
        return NULL;
    }
    const uint8_t *rgba = (const uint8_t *)buf.buf;

    /* filtered scanlines: 1 filter byte + stride per row */
    Py_ssize_t raw_len = (stride + 1) * height;
    uint8_t *raw = (uint8_t *)malloc(raw_len);
    if (!raw) { PyBuffer_Release(&buf); return PyErr_NoMemory(); }

    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t y = 0; y < height; y++) {
        const uint8_t *row = rgba + y * stride;
        const uint8_t *prev = (y > 0) ? rgba + (y - 1) * stride : NULL;
        uint8_t *out = raw + y * (stride + 1);
        out[0] = 4; /* Paeth */
        for (Py_ssize_t x = 0; x < stride; x++) {
            int a = (x >= 4) ? row[x - 4] : 0;
            int b = prev ? prev[x] : 0;
            int c = (prev && x >= 4) ? prev[x - 4] : 0;
            out[1 + x] = (uint8_t)(row[x] - paeth(a, b, c));
        }
    }
    Py_END_ALLOW_THREADS

    uLongf comp_cap = compressBound((uLong)raw_len);
    uint8_t *comp = (uint8_t *)malloc(comp_cap);
    if (!comp) { free(raw); PyBuffer_Release(&buf);
                 return PyErr_NoMemory(); }
    int zrc;
    Py_BEGIN_ALLOW_THREADS
    zrc = compress2(comp, &comp_cap, raw, (uLong)raw_len, level);
    Py_END_ALLOW_THREADS
    free(raw);
    if (zrc != Z_OK) {
        free(comp); PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_RuntimeError, "zlib compress failed");
        return NULL;
    }

    /* assemble: sig(8) IHDR(25) IDAT(12+n) IEND(12) */
    Py_ssize_t total = 8 + 25 + (12 + (Py_ssize_t)comp_cap) + 12;
    PyObject *res = PyBytes_FromStringAndSize(NULL, total);
    if (!res) { free(comp); PyBuffer_Release(&buf); return NULL; }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(res);

    static const uint8_t sig[8] =
        {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    memcpy(p, sig, 8); p += 8;

    /* IHDR */
    put_be32(p, 13); memcpy(p + 4, "IHDR", 4);
    put_be32(p + 8, (uint32_t)width);
    put_be32(p + 12, (uint32_t)height);
    p[16] = 8;  /* bit depth */
    p[17] = 6;  /* color type RGBA */
    p[18] = 0; p[19] = 0; p[20] = 0;
    put_be32(p + 21, (uint32_t)crc32(0, p + 4, 17));
    p += 25;

    /* IDAT */
    put_be32(p, (uint32_t)comp_cap); memcpy(p + 4, "IDAT", 4);
    memcpy(p + 8, comp, comp_cap);
    {
        uLong c = crc32(0, p + 4, 4);
        c = crc32(c, p + 8, (uInt)comp_cap);
        put_be32(p + 8 + comp_cap, (uint32_t)c);
    }
    p += 12 + comp_cap;
    free(comp);

    /* IEND */
    put_be32(p, 0); memcpy(p + 4, "IEND", 4);
    put_be32(p + 8, (uint32_t)crc32(0, p + 4, 4));

    PyBuffer_Release(&buf);
    return res;
}

/* ------------------------------------------------------------- YCbCr */

static PyObject *fastout_rgb_to_ycbcr444(PyObject *self,
                                         PyObject *args) {
    Py_buffer buf;
    Py_ssize_t width, height;
    if (!PyArg_ParseTuple(args, "y*nn", &buf, &width, &height))
        return NULL;
    if (width <= 0 || height <= 0) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError,
                        "width and height must be positive");
        return NULL;
    }
    Py_ssize_t npix = width * height;
    if (buf.len < npix * 4) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "buffer too small for WxHx4");
        return NULL;
    }
    PyObject *res = PyBytes_FromStringAndSize(NULL, npix * 3);
    if (!res) { PyBuffer_Release(&buf); return NULL; }
    const uint8_t *rgba = (const uint8_t *)buf.buf;
    uint8_t *out = (uint8_t *)PyBytes_AS_STRING(res);
    uint8_t *yp = out, *cb = out + npix, *cr = out + 2 * npix;

    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < npix; i++) {
        int r = rgba[4 * i], g = rgba[4 * i + 1], b = rgba[4 * i + 2];
        /* BT.601 full-range, fixed point (x1024) */
        int y  = (306 * r + 601 * g + 117 * b + 512) >> 10;
        int pb = ((-173 * r - 339 * g + 512 * b + 512) >> 10) + 128;
        int pr = ((512 * r - 429 * g - 83 * b + 512) >> 10) + 128;
        yp[i] = (uint8_t)(y < 0 ? 0 : y > 255 ? 255 : y);
        cb[i] = (uint8_t)(pb < 0 ? 0 : pb > 255 ? 255 : pb);
        cr[i] = (uint8_t)(pr < 0 ? 0 : pr > 255 ? 255 : pr);
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&buf);
    return res;
}

/* ------------------------------------------------------------ module */

static PyMethodDef methods[] = {
    {"encode_png", fastout_encode_png, METH_VARARGS,
     "encode_png(rgba_bytes, width, height, level=6) -> PNG bytes"},
    {"rgb_to_ycbcr444", fastout_rgb_to_ycbcr444, METH_VARARGS,
     "rgb_to_ycbcr444(rgba_bytes, width, height) -> planar YCbCr"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastout",
    "native output-path encoders (PNG via zlib, YCbCr conversion)",
    -1, methods};

PyMODINIT_FUNC PyInit_fastout(void) {
    return PyModule_Create(&moduledef);
}
