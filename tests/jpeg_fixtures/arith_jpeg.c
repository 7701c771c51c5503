/* Write an arithmetic-coded JPEG (SOF9) with libjpeg: the helper of
 * make_jpeg_fixtures.py, which compiles and runs it.
 *
 *     cc -O2 arith_jpeg.c -ljpeg -o arith_jpeg
 *     arith_jpeg WIDTH HEIGHT QUALITY < rgb.raw > out.jpg
 *
 * Reads WIDTH x HEIGHT x 3 bytes of RGB on stdin and writes the JPEG on
 * stdout: YCbCr 4:2:0 (libjpeg's default), arithmetic coding. */
#include <stdio.h>
#include <stdlib.h>

#include <jpeglib.h>

int main(int argc, char** argv) {
    if (argc != 4) {
        fprintf(stderr, "usage: %s WIDTH HEIGHT QUALITY\n", argv[0]);
        return 2;
    }
    const int w = atoi(argv[1]), h = atoi(argv[2]), q = atoi(argv[3]);
    const size_t n = (size_t)w * h * 3;
    unsigned char* rgb = malloc(n);
    if (rgb == NULL || fread(rgb, 1, n, stdin) != n) return 1;
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr err;
    c.err = jpeg_std_error(&err);
    jpeg_create_compress(&c);
    jpeg_stdio_dest(&c, stdout);
    c.image_width = w;
    c.image_height = h;
    c.input_components = 3;
    c.in_color_space = JCS_RGB;
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, q, TRUE);
    c.arith_code = TRUE;
    jpeg_start_compress(&c, TRUE);
    while (c.next_scanline < c.image_height) {
        JSAMPROW row = rgb + (size_t)c.next_scanline * w * 3;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    jpeg_destroy_compress(&c);
    free(rgb);
    return 0;
}
